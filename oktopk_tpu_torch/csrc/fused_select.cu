// Fused selection front-end for Hopper (sm_90a).
//
// Replaces oktopk_tpu/ops/fused_select.py::_fused_kernel (K1, :64). One
// sweep over (grad, residual) computes and writes acc = grad + residual
// (the only n-scale write) and, in the same pass:
//   - tile_counts[b]: survivors |acc| >= max(t, 2^-126) in 1024-element
//     tile b (the compaction kernel's write pass takes these and skips its
//     own count pass), and their total (the realised local count);
//   - the Newton probe count |acc| >= tp at the UNclamped tp;
//   - a 256-bin histogram of the f32 biased exponent of the nonzero
//     elements (subnormals in bin 1, inf/nan in bin 255), bit-identical to
//     ops/hist_threshold.py::log2_hist.
// The TPU kernel also staged survivor offsets for its compaction; here the
// compaction writes the final triple itself from the tile counts.
//
// What bounds it: memory. Two reads and one write of n floats, 12n bytes
// (176.7 MB at n = 14,728,266: about 53 us at 3.35 TB/s). Each element is
// touched once; the counts are warp-shuffle reductions and the histogram
// is shared-memory integer atomics, merged into the global bins once per
// tile (integer adds: order-free, so bit-exact). Loads are 4-byte and
// coalesced, so rows of a [P, n] buffer need not be 16-byte aligned.
//
// Built without --use_fast_math and without -ftz=true: acc keeps
// subnormals and the histogram bins them, as the plain version does.

#include <cuda_runtime.h>
#include <stdint.h>

#define TILE 1024
#define THREADS 256
#define WARPS (THREADS / 32)
#define HIST_BINS 256
#define MIN_NORMAL 1.17549435e-38f

// stats: [0] local count, [1] probe count, [2 .. 2+HIST_BINS) histogram
__global__ void fs_zero(int* __restrict__ stats) {
  for (int i = threadIdx.x; i < 2 + HIST_BINS; i += blockDim.x) stats[i] = 0;
}

__global__ void fs_sweep(const float* __restrict__ grad,
                         const float* __restrict__ res,
                         float* __restrict__ acc, int64_t n,
                         const float* __restrict__ t_ptr,
                         const float* __restrict__ tp_ptr,
                         int* __restrict__ tile_counts,
                         int* __restrict__ stats) {
  __shared__ int hist[HIST_BINS];
  __shared__ int warp_c[WARPS];
  __shared__ int warp_p[WARPS];
  for (int i = threadIdx.x; i < HIST_BINS; i += THREADS) hist[i] = 0;
  __syncthreads();

  const float t0 = *t_ptr;
  const float t = (t0 < MIN_NORMAL) ? MIN_NORMAL : t0;
  const float tp = *tp_ptr;
  const int64_t base = (int64_t)blockIdx.x * TILE;
  int c = 0, p = 0;
#pragma unroll
  for (int k = 0; k < TILE / THREADS; ++k) {
    const int64_t i = base + k * THREADS + threadIdx.x;
    if (i < n) {
      const float a = __fadd_rn(grad[i], res[i]);
      acc[i] = a;
      const float ax = fabsf(a);
      c += (ax >= t);
      p += (ax >= tp);
      const unsigned mag = __float_as_uint(a) & 0x7fffffffu;
      if (mag != 0u) {
        const int e = (int)(mag >> 23);
        atomicAdd(&hist[e < 1 ? 1 : e], 1);
      }
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    c += __shfl_down_sync(0xffffffffu, c, off);
    p += __shfl_down_sync(0xffffffffu, p, off);
  }
  if ((threadIdx.x & 31) == 0) {
    warp_c[threadIdx.x >> 5] = c;
    warp_p[threadIdx.x >> 5] = p;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int sc = 0, sp = 0;
    for (int w = 0; w < WARPS; ++w) {
      sc += warp_c[w];
      sp += warp_p[w];
    }
    tile_counts[blockIdx.x] = sc;
    if (sc) atomicAdd(&stats[0], sc);
    if (sp) atomicAdd(&stats[1], sp);
  }
  for (int i = threadIdx.x; i < HIST_BINS; i += THREADS) {
    const int h = hist[i];
    if (h) atomicAdd(&stats[2 + i], h);
  }
}

// grad, res: [n] f32; acc: [n] f32 out; t_ptr/tp_ptr: one f32 each on the
// device; tile_counts: [ceil(n/1024)] i32 out; stats: [2 + 256] i32 out.
extern "C" int oktopk_fused_select(const float* grad, const float* res,
                                   float* acc, int64_t n, const float* t_ptr,
                                   const float* tp_ptr, int* tile_counts,
                                   int* stats, cudaStream_t stream) {
  if (n < 1 || n >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const int ntiles = (int)((n + TILE - 1) / TILE);
  fs_zero<<<1, THREADS, 0, stream>>>(stats);
  fs_sweep<<<ntiles, THREADS, 0, stream>>>(grad, res, acc, n, t_ptr, tp_ptr,
                                           tile_counts, stats);
  return (int)cudaGetLastError();
}
