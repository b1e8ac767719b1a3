// Threshold stream compaction for Hopper (sm_90a).
//
// Replaces oktopk_tpu/ops/compaction.py::_stage_kernel (K2, :160) and
// ::_repair_kernel (K3, :229) together with their XLA post-processing
// (_materialize, _materialize_het, _region_counts, _pack_finalize). The
// output contract is the same: for R contiguous index regions
// [bnd[r], bnd[r+1]) of x[0, n), the survivors |x| >= max(t, 2^-126) go to
// values[r, slot] / indices[r, slot] in ascending index order, slot =
// (global survivor rank) - (survivors before bnd[r]); survivors past cap
// are dropped lowest-index-first, empty slots hold 0 and the sentinel n,
// and counts[r] = min(survivors in r, cap).
//
// Why one kernel covers K2 and K3: the TPU stages at most 128 survivors per
// 1024-element block in a fixed staging row and needs K3 to re-stage the
// blocks that overflow it (or the 1024-wide K2 when too many do). Here each
// survivor computes its own output slot from a tile prefix and writes it
// directly, so a tile of any survivor count (0 to 1024) is handled in the
// same body: there is no staging width to overflow.
//
// Passes (one C call, all on the caller's stream):
//   1. cp_count: survivors per 1024-element tile (skipped when the fused
//      front-end kernel already produced the tile counts).
//   2. cp_scan: one block; exclusive scan of the tile counts, the survivor
//      count before every boundary (the boundary's own tile is re-read, at
//      most 1024 elements a boundary), and the clipped region counts.
//   3. cp_write: per tile, a warp-ballot/popc rank inside each warp, warp
//      totals through shared memory, then one store per survivor; the
//      grid-stride fill of the empty slots runs in the same launch.
//
// What bounds it: memory. It must read x once (4n bytes: 58.9 MB at
// n = 14,728,266, about 18 us at 3.35 TB/s); the writes are cap-scale.
// This simple version reads x twice when it counts its own tiles (passes
// 1 and 3), once when the fused kernel counted them. Loads are 4-byte and
// coalesced; rows of a [P, n] buffer need not be 16-byte aligned.
//
// Built without --use_fast_math and without -ftz=true: subnormal x must
// compare as subnormal, as in the plain PyTorch version.

#include <cuda_runtime.h>
#include <stdint.h>

#define TILE 1024
#define THREADS 256
#define WARPS (THREADS / 32)
#define MAX_REGIONS 64
#define MIN_NORMAL 1.17549435e-38f

__device__ __forceinline__ float clamp_threshold(const float* t_ptr) {
  // jnp.maximum(t, min_normal): NaN stays NaN (then nothing survives)
  float t = *t_ptr;
  return (t < MIN_NORMAL) ? MIN_NORMAL : t;
}

__global__ void cp_count(const float* __restrict__ x, int64_t n,
                         const float* __restrict__ t_ptr,
                         int* __restrict__ tile_counts) {
  __shared__ int warp_tot[WARPS];
  const float t = clamp_threshold(t_ptr);
  const int64_t base = (int64_t)blockIdx.x * TILE;
  int c = 0;
#pragma unroll
  for (int k = 0; k < TILE / THREADS; ++k) {
    const int64_t i = base + k * THREADS + threadIdx.x;
    if (i < n && fabsf(x[i]) >= t) ++c;
  }
  for (int off = 16; off > 0; off >>= 1)
    c += __shfl_down_sync(0xffffffffu, c, off);
  if ((threadIdx.x & 31) == 0) warp_tot[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int w = 0; w < WARPS; ++w) s += warp_tot[w];
    tile_counts[blockIdx.x] = s;
  }
}

// One block of TILE threads.
__global__ void cp_scan(const int* __restrict__ tile_counts, int ntiles,
                        const float* __restrict__ x, int64_t n,
                        const float* __restrict__ t_ptr,
                        const int* __restrict__ bnd, int R, int cap,
                        int* __restrict__ excl, int* __restrict__ before,
                        int* __restrict__ counts) {
  __shared__ int chunk_sum[TILE];
  const int tid = threadIdx.x;
  const int per = (ntiles + TILE - 1) / TILE;
  const int lo = tid * per;
  const int hi = min(lo + per, ntiles);
  int s = 0;
  for (int i = lo; i < hi; ++i) s += tile_counts[i];
  chunk_sum[tid] = s;
  __syncthreads();
  // Hillis-Steele inclusive scan over the TILE chunk sums
  for (int off = 1; off < TILE; off <<= 1) {
    int v = (tid >= off) ? chunk_sum[tid - off] : 0;
    __syncthreads();
    chunk_sum[tid] += v;
    __syncthreads();
  }
  int run = chunk_sum[tid] - s;
  for (int i = lo; i < hi; ++i) {
    excl[i] = run;
    run += tile_counts[i];
  }
  if (tid == TILE - 1) excl[ntiles] = chunk_sum[TILE - 1];
  __syncthreads();

  const float t = clamp_threshold(t_ptr);
  const int total = chunk_sum[TILE - 1];
  for (int r = 0; r <= R; ++r) {
    // survivors with index < b: whole tiles before b's tile, plus the
    // part of b's own tile below b
    const int64_t b = bnd ? (int64_t)bnd[r] : (r == 0 ? 0 : n);
    const int64_t tb = b / TILE;
    const int64_t i = tb * TILE + tid;
    const int pred = (tb < ntiles) && i < b && i < n && fabsf(x[i]) >= t;
    const int part = __syncthreads_count(pred);
    if (tid == 0) before[r] = (tb < ntiles) ? excl[tb] + part : total;
  }
  __syncthreads();
  if (tid < R) counts[tid] = min(before[tid + 1] - before[tid], cap);
}

__global__ void cp_write(const float* __restrict__ x, int64_t n,
                         const float* __restrict__ t_ptr,
                         const int* __restrict__ bnd, int R, int cap,
                         const int* __restrict__ excl,
                         const int* __restrict__ before,
                         const int* __restrict__ counts,
                         float* __restrict__ values,
                         int* __restrict__ indices) {
  __shared__ int s_bnd[MAX_REGIONS + 1];
  __shared__ int s_before[MAX_REGIONS + 1];
  __shared__ int s_counts[MAX_REGIONS];
  __shared__ int warp_tot[WARPS];
  const int tid = threadIdx.x;
  for (int r = tid; r <= R; r += THREADS) {
    s_bnd[r] = bnd ? bnd[r] : (r == 0 ? 0 : (int)n);
    s_before[r] = before[r];
    if (r < R) s_counts[r] = counts[r];
  }
  __syncthreads();

  // empty slots: value 0, index n
  const int64_t slots = (int64_t)R * cap;
  for (int64_t j = (int64_t)blockIdx.x * THREADS + tid; j < slots;
       j += (int64_t)gridDim.x * THREADS) {
    const int r = (int)(j / cap);
    if ((int)(j - (int64_t)r * cap) >= s_counts[r]) {
      values[j] = 0.0f;
      indices[j] = (int)n;
    }
  }

  const float t = clamp_threshold(t_ptr);
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;
  const int64_t base = (int64_t)blockIdx.x * TILE;
  int run = excl[blockIdx.x];
#pragma unroll
  for (int k = 0; k < TILE / THREADS; ++k) {
    const int64_t i = base + k * THREADS + tid;
    const float v = (i < n) ? x[i] : 0.0f;
    const bool keep = (i < n) && fabsf(v) >= t;
    const unsigned bal = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) warp_tot[warp] = __popc(bal);
    __syncthreads();
    int woff = 0, tot = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int c = warp_tot[w];
      woff += (w < warp) ? c : 0;
      tot += c;
    }
    if (keep) {
      const int g = run + woff + __popc(bal & lanes_below);
      int r = 0;  // searchsorted(bnd[1:-1], i, side="right")
      for (int q = 1; q < R; ++q) r += (s_bnd[q] <= i);
      const int slot = g - s_before[r];
      if (slot < cap) {
        values[(int64_t)r * cap + slot] = v;
        indices[(int64_t)r * cap + slot] = (int)i;
      }
    }
    run += tot;
    __syncthreads();
  }
}

// x: [n] f32; t_ptr: one f32 on the device (clamped here); bnd: [R+1] i32
// region offsets or NULL for one region [0, n); tile_counts_in: [ntiles]
// i32 from the fused kernel, or NULL to count here; scratch: tile_counts
// [ntiles], excl [ntiles+1], before [R+1] (i32, uninitialised); outputs:
// values [R*cap] f32, indices [R*cap] i32, counts [R] i32.
extern "C" int oktopk_compact(const float* x, int64_t n, const float* t_ptr,
                              const int* bnd, int R, int cap,
                              const int* tile_counts_in, int* tile_counts,
                              int* excl, int* before, float* values,
                              int* indices, int* counts,
                              cudaStream_t stream) {
  if (R < 1 || R > MAX_REGIONS || cap < 1 || n < 1 || n >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int ntiles = (int)((n + TILE - 1) / TILE);
  const int* tc = tile_counts_in;
  if (!tc) {
    cp_count<<<ntiles, THREADS, 0, stream>>>(x, n, t_ptr, tile_counts);
    tc = tile_counts;
  }
  cp_scan<<<1, TILE, 0, stream>>>(tc, ntiles, x, n, t_ptr, bnd, R, cap,
                                  excl, before, counts);
  cp_write<<<ntiles, THREADS, 0, stream>>>(x, n, t_ptr, bnd, R, cap, excl,
                                           before, counts, values, indices);
  return (int)cudaGetLastError();
}
