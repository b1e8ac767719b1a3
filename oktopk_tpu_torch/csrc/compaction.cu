// Threshold stream compaction for Hopper (sm_90a): one pass over x.
//
// Replaces oktopk_tpu/ops/compaction.py::_stage_kernel (K2, :160) and
// ::_repair_kernel (K3, :229) together with their XLA post-processing
// (_materialize, _materialize_het, _region_counts, _pack_finalize); the
// stand-alone K3 prototype scripts/proto_repair_kernel.py:78 computes a
// part of the same function. The output contract is the same: for R
// contiguous index regions [bnd[r], bnd[r+1]) of x[0, n), the survivors
// |x| >= max(t, 2^-126) go to values[r, slot] / indices[r, slot] in
// ascending index order, slot = (global survivor rank) - (survivors before
// bnd[r]); survivors past cap are dropped lowest-index-first, empty slots
// hold 0 and the sentinel n, and counts[r] = min(survivors in r, cap). A
// NaN threshold keeps nothing. The TPU stages at most 128 survivors per
// 1024-element block and needs K3 for the blocks that overflow; here each
// survivor is stored at its own slot, so no tile can overflow.
//
// What bounds it: memory. x must be read once (4n bytes: 58.9 MB at
// n = 14,728,266, 17.6 us at 3.35 TB/s) and the outputs written once
// (8 R cap bytes: 4.7 MB at R = 4, cap = 147,290).
//
// Design: two launches on the caller's stream.
//   1. cp_prefill: every slot gets (0, n); the tile ticket, the region
//      offsets and the look-back status words in the scratch are zeroed.
//   2. cp_compact: single-pass compaction with decoupled look-back
//      (Merrill & Garland, "Single-pass Parallel Prefix Scan with
//      Decoupled Look-back", NVIDIA 2016), one block per tile of
//      TILE = 4096 elements:
//      - the block takes its tile from an atomic ticket, so it only ever
//        waits on tiles whose blocks already run;
//      - each lane loads four 16-byte quads, all issued before any use,
//        warp-striped so that each load instruction of a warp reads 512
//        contiguous bytes;
//      - one warp scan (the four per-quad counts of a lane packed one per
//        byte) and one shared scan of the warp totals rank the survivors
//        inside the tile; they are staged in shared memory in index order;
//      - the block publishes its survivor count as a (flag, value) word;
//        warp 0 looks back over the 32 nearest predecessors at a time,
//        waiting only for the run down to the nearest inclusive prefix,
//        and publishes its own inclusive prefix;
//      - consecutive threads then store consecutive slots.
//   Region offsets come from the same pass: the tile holding bnd[r] adds
//   the survivors of its elements below bnd[r] to its prefix and
//   publishes before[r] with a flag; tiles of region r fetch it (it comes
//   from a smaller ticket) while warp 0 looks back, and the tile holding
//   bnd[r+1] writes counts[r].
//   The flag and the value of a status word travel in one 64-bit word,
//   which is single-copy atomic, and nothing else is published through
//   it: relaxed loads and stores suffice.
// Tiles are cut on 16-byte boundaries of memory, not of x: a row of a
// [P, n] buffer may start 4, 8 or 12 bytes off, so x[0] sits `shift`
// elements into tile 0, and a quad crossing either end of x loads its
// elements one by one.
//
// Every count is an integer and no float is summed, so the result is
// deterministic and bit-equal to the plain version. Built without
// --use_fast_math and without -ftz=true: subnormal x must compare as
// subnormal, as in the plain PyTorch version.

#include <cuda_runtime.h>
#include <stdint.h>

// a tile: 256 threads x 16 elements (four 16-byte quads a lane); 5 blocks
// an SM at 48 registers. ops/compaction.py's TILE must match.
#define THREADS 256
#define ITEMS 16
#define MIN_BLOCKS 5
#define WARPS (THREADS / 32)
#define TILE (THREADS * ITEMS)
#define QUADS (ITEMS / 4)
#define MAX_REGIONS 64
#define MIN_NORMAL 1.17549435e-38f
#define FULL 0xffffffffu

// status and region-offset words: flag in the high 32 bits, value low
#define FLAG_AGGREGATE 1ull
#define FLAG_PREFIX 2ull

typedef unsigned long long u64;

__device__ __forceinline__ void publish(u64* p, u64 v) {
  asm volatile("st.relaxed.gpu.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ u64 peek(const u64* p) {
  u64 v;
  asm volatile("ld.relaxed.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ u64 flagged(u64 flag, int v) {
  return (flag << 32) | (unsigned)v;
}

// value of a flagged word, once its flag is set
__device__ __forceinline__ int wait_value(const u64* p) {
  u64 w;
  while (((w = peek(p)) >> 32) == 0) __nanosleep(32);
  return (int)(unsigned)w;
}

// bits of the elements of a quad below element e (e < 4)
__device__ __forceinline__ unsigned below(int e) { return (1u << e) - 1u; }

// tile holding element index b (b == n may lie past the last tile's end)
__device__ __forceinline__ int tile_of(int b, int shift, int ntiles) {
  return min((int)(((int64_t)b + shift) / TILE), ntiles - 1);
}

// tile-relative element offset of quad q of thread tid (warp-striped)
__device__ __forceinline__ int quad_at(int q, int tid) {
  return (tid >> 5) * (32 * ITEMS) + q * 128 + (tid & 31) * 4;
}

__global__ void cp_prefill(float* __restrict__ values,
                           int* __restrict__ indices, int64_t slots, int n,
                           u64* __restrict__ scratch, int64_t words) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t j0 = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (int64_t j = j0; j < words; j += stride) scratch[j] = 0ull;
  const int64_t quads = slots / 4;
  float4* v4 = reinterpret_cast<float4*>(values);
  int4* i4 = reinterpret_cast<int4*>(indices);
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const int4 sentinel = make_int4(n, n, n, n);
  for (int64_t j = j0; j < quads; j += stride) {
    v4[j] = zero;
    i4[j] = sentinel;
  }
  for (int64_t j = quads * 4 + j0; j < slots; j += stride) {
    values[j] = 0.0f;
    indices[j] = n;
  }
}

// scratch: [0] tile ticket, [1, R+2) before[r], [R+2, R+2+ntiles) status
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
cp_compact(const float* __restrict__ x, int n, int shift, int ntiles,
           const float* __restrict__ t_ptr, const int* __restrict__ bnd,
           int R, int cap, u64* __restrict__ scratch,
           float* __restrict__ values, int* __restrict__ indices,
           int* __restrict__ counts) {
  __shared__ int s_tile, s_excl, s_rlo;
  __shared__ int s_warp[WARPS];
  __shared__ int s_bnd[MAX_REGIONS + 1];
  __shared__ int s_part[MAX_REGIONS + 1];
  __shared__ int s_before[MAX_REGIONS + 1];
  __shared__ float s_val[TILE];  // the tile's survivors in index order
  __shared__ int s_idx[TILE];
  unsigned* ticket = reinterpret_cast<unsigned*>(scratch);
  u64* g_before = scratch + 1;
  u64* status = scratch + R + 2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (tid == 0) s_tile = (int)atomicAdd(ticket, 1u);
  for (int r = tid; r <= R; r += THREADS)
    s_bnd[r] = bnd ? bnd[r] : (r == 0 ? 0 : n);
  // jnp.maximum(t, min_normal): NaN stays NaN (then nothing survives)
  const float t0 = *t_ptr;
  const float t = (t0 < MIN_NORMAL) ? MIN_NORMAL : t0;
  __syncthreads();
  const int tile = s_tile;

  // ---- load: quads inside x as float4, all issued before any use; a
  // quad crossing either end of x element by element; elements outside x
  // read 0, which never survives (t >= 2^-126, or NaN)
  const int64_t tile_v = (int64_t)tile * TILE;  // first virtual index
  const int64_t base = tile_v - shift;           // real index of element 0
  float v[ITEMS];
  if (base >= 0 && base + TILE <= n) {
#pragma unroll
    for (int q = 0; q < QUADS; ++q) {
      const float4 f =
          __ldg(reinterpret_cast<const float4*>(x + base + quad_at(q, tid)));
      v[4 * q] = f.x;
      v[4 * q + 1] = f.y;
      v[4 * q + 2] = f.z;
      v[4 * q + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < QUADS; ++q) {
      const int64_t i = base + quad_at(q, tid);
      if (i >= 0 && i + 4 <= n) {
        const float4 f = __ldg(reinterpret_cast<const float4*>(x + i));
        v[4 * q] = f.x;
        v[4 * q + 1] = f.y;
        v[4 * q + 2] = f.z;
        v[4 * q + 3] = f.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[4 * q + e] = (i + e >= 0 && i + e < n) ? __ldg(x + i + e) : 0.0f;
      }
    }
  }
  unsigned m = 0;  // bit 4q + e: element e of quad q survives
#pragma unroll
  for (int e = 0; e < ITEMS; ++e) m |= (unsigned)(fabsf(v[e]) >= t) << e;

  // ---- ranks inside the tile: qbase[q] = survivors of the tile before
  // quad q of this thread. A lane's quad counts (<= 4 each, <= 128 summed
  // over a warp) are packed one per byte, so that one warp scan ranks them
  // all; then a scan of the warp totals.
  unsigned pk = 0;
#pragma unroll
  for (int q = 0; q < QUADS; ++q)
    pk |= (unsigned)__popc((m >> (4 * q)) & 15u) << (8 * q);
  unsigned inc = pk;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned y = __shfl_up_sync(FULL, inc, off);
    if (lane >= off) inc += y;
  }
  const unsigned tot = __shfl_sync(FULL, inc, 31);
  if (lane == 31) {
    int s = 0;
#pragma unroll
    for (int q = 0; q < QUADS; ++q) s += (tot >> (8 * q)) & 255u;
    s_warp[warp] = s;
  }
  __syncthreads();
  int run = 0, agg = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const int s = s_warp[w];
    run += (w < warp) ? s : 0;
    agg += s;
  }
  int qbase[QUADS];
  const unsigned ex = inc - pk;
#pragma unroll
  for (int q = 0; q < QUADS; ++q) {
    qbase[q] = run + (int)((ex >> (8 * q)) & 255u);
    run += (int)((tot >> (8 * q)) & 255u);
  }
  if (tid == 0)
    publish(&status[tile],
            flagged(tile == 0 ? FLAG_PREFIX : FLAG_AGGREGATE, agg));

  // survivors of this tile below each boundary the tile holds
  for (int r = 0; r <= R; ++r) {
    const int b = s_bnd[r];
    if (tile_of(b, shift, ntiles) != tile) continue;
    const int local = (int)((int64_t)b + shift - tile_v);  // 0 .. TILE
    if (local == TILE) {
      if (tid == 0) s_part[r] = agg;
      continue;
    }
    const int o = local % (32 * ITEMS);
    if (tid == local / (32 * ITEMS) * 32 + (o % 128) / 4) {
      int part = 0;
#pragma unroll
      for (int q = 0; q < QUADS; ++q)
        if (q == o / 128)
          part = qbase[q] + __popc((m >> (4 * q)) & below(local % 4));
      s_part[r] = part;
    }
  }
  // stage the survivors in index order (the tile's values die here)
#pragma unroll
  for (int q = 0; q < QUADS; ++q) {
    int p = qbase[q];
    const int64_t i = base + quad_at(q, tid);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if ((m >> (4 * q + e)) & 1u) {
        s_val[p] = v[4 * q + e];
        s_idx[p] = (int)(i + e);
        ++p;
      }
    }
  }

  if (warp == WARPS - 1) {
    // while warp 0 looks back: the region of the tile's first element,
    // and the offsets of regions that start in earlier tiles where this
    // tile needs them (for its survivors, or for counts[r])
    const int first = base > 0 ? (int)base : 0;
    for (int r = lane; r < R; r += 32) {
      const bool holds_first =
          s_bnd[r] <= first && (r == R - 1 || s_bnd[r + 1] > first);
      const bool ends_here = tile_of(s_bnd[r + 1], shift, ntiles) == tile;
      if (holds_first) s_rlo = r;
      if (tile_of(s_bnd[r], shift, ntiles) != tile)
        s_before[r] = (s_bnd[r] > 0 && ((holds_first && agg > 0) || ends_here))
                          ? wait_value(&g_before[r])
                          : 0;
    }
  }
  // ---- decoupled look-back: warp 0, 32 predecessors a round (lane l
  // reads tile newest - l). It waits only for the run of predecessors down
  // to the nearest one with an inclusive prefix, not for all 32.
  if (warp == 0) {
    int excl = 0;
    if (tile > 0) {
      for (int newest = tile - 1;; newest -= 32) {
        const int j = newest - lane;
        u64 w = (j >= 0) ? peek(&status[j]) : flagged(FLAG_PREFIX, 0);
        unsigned pre, need;
        while (true) {
          pre = __ballot_sync(FULL, (w >> 32) == FLAG_PREFIX);
          // lanes 0 .. nearest prefix, or all 32 when the round has none
          need = pre ? ((pre & (0u - pre)) << 1) - 1u : FULL;
          const unsigned ready = __ballot_sync(FULL, (w >> 32) != 0);
          if ((ready & need) == need) break;
          if (((need >> lane) & 1u) && (w >> 32) == 0) w = peek(&status[j]);
        }
        excl += (int)__reduce_add_sync(
            FULL, ((need >> lane) & 1u) ? (unsigned)w : 0u);
        if (pre) break;
      }
      if (lane == 0) publish(&status[tile], flagged(FLAG_PREFIX, excl + agg));
    }
    if (lane == 0) s_excl = excl;
  }
  __syncthreads();
  const int excl = s_excl;

  // ---- offsets of the regions that start in this tile
  if (tid <= R && tile_of(s_bnd[tid], shift, ntiles) == tile) {
    const int before = excl + s_part[tid];
    s_before[tid] = before;
    publish(&g_before[tid], flagged(FLAG_PREFIX, before));
  }
  __syncthreads();
  if (tid < R && tile_of(s_bnd[tid + 1], shift, ntiles) == tile)
    counts[tid] = min(s_before[tid + 1] - s_before[tid], cap);

  // ---- store the survivors: consecutive threads, consecutive slots
  for (int j = tid; j < agg; j += THREADS) {
    const int idx = s_idx[j];
    int r = s_rlo;
    while (r + 1 < R && s_bnd[r + 1] <= idx) ++r;
    const int slot = excl + j - s_before[r];
    if ((unsigned)slot < (unsigned)cap) {
      values[(int64_t)r * cap + slot] = s_val[j];
      indices[(int64_t)r * cap + slot] = idx;
    }
  }
}

// x: [n] f32, 4-byte aligned; t_ptr: one f32 on the device (clamped here);
// bnd: [R+1] i32 region offsets spanning [0, n], or NULL for one region
// [0, n); scratch: at least R + 2 + ntiles u64 words, uninitialised
// (ntiles = ceil((n + shift) / TILE), shift = (x's address / 4) mod 4);
// outputs, 16-byte aligned: values [R*cap] f32, indices [R*cap] i32,
// counts [R] i32.
extern "C" int oktopk_compact(const float* x, int64_t n, const float* t_ptr,
                              const int* bnd, int R, int cap,
                              unsigned long long* scratch,
                              int64_t scratch_words, float* values,
                              int* indices, int* counts,
                              cudaStream_t stream) {
  if (R < 1 || R > MAX_REGIONS || cap < 1 || n < 1 || n >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const uintptr_t xa = (uintptr_t)x;
  if ((xa & 3) || (((uintptr_t)values | (uintptr_t)indices) & 15))
    return (int)cudaErrorMisalignedAddress;
  const int shift = (int)((xa >> 2) & 3);
  const int64_t ntiles = (n + shift + TILE - 1) / TILE;
  if (scratch_words < R + 2 + ntiles) return (int)cudaErrorInvalidValue;
  const int64_t slots = (int64_t)R * cap;
  const int64_t fill = (slots / 4 > scratch_words ? slots / 4 : scratch_words);
  const int fill_blocks = (int)(fill / THREADS + 1 < 1056 ? fill / THREADS + 1
                                                          : 1056);
  cp_prefill<<<fill_blocks, THREADS, 0, stream>>>(values, indices, slots,
                                                  (int)n, scratch,
                                                  scratch_words);
  cp_compact<<<(unsigned)ntiles, THREADS, 0, stream>>>(
      x, (int)n, shift, (int)ntiles, t_ptr, bnd, R, cap, scratch, values,
      indices, counts);
  return (int)cudaGetLastError();
}
