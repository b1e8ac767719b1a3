// oktopk's combine phase for Hopper (sm_90a): the scatters of the
// exchanged (value, index) rows into dense [W, n] rows, and the
// error-feedback residual update, in one pass each.
//
// Replaces no Pallas kernel: the JAX package (oktopk_tpu/collectives/
// oktopk.py) leaves this phase to XLA's scatter and elementwise ops. The
// port's plain composition (ops/select.py::scatter_rows, then
// collectives/wire.py::residual_after_winners over the masks
// result != 0 and |acc| >= lt) zero-fills [W, n + 1] buffers, hands out
// their strided [:, :n] views, and under the bf16 wire makes about ten
// separate [W, n] passes with a tensor written by each.
//
// What bounds it: memory. At BERT-base's n = 110,106,428 and W = 4 one
// [W, n] float32 tensor is 1.762 GB. The residual update must read acc,
// reduced and result and write the residual: 7.05 GB, 2.10 ms at
// 3.35 TB/s. The two scatters must zero-fill their outputs: 3.52 GB,
// 1.05 ms. The scatter-adds themselves touch R x cap pairs a scatter
// (about 9-11 M), well under 0.5 ms.
//
// Design:
//   - oktopk_scatter_rows: one cudaMemsetAsync of the contiguous [W, n]
//     output, then one cb_scatter launch per source row r, each covering
//     all W workers (blockIdx.y). The indices of one worker's row are
//     distinct, so no two threads of a launch meet on an element; the
//     rows' launches run in rank order on the stream, so each sum is
//     added in the order of the plain version's scatter_add_ (H2). The
//     add is an atomicAdd whose result is unused (a fire-and-forget
//     reduction in L2, no load round trip), not for ordering: it is the
//     instruction the plain scatter_add_ runs on the card, one rounding to
//     nearest that flushes subnormal sums to zero, so the sums are bit
//     for bit the plain version's there (the CPU's plain version keeps
//     subnormals; the card's float atomics cannot).
//     The sentinel index n (and anything outside [0, n)) drops in the
//     kernel: no n + 1 column. The [W, R, cap] inputs are read through
//     their strides, so the comm's transposed and broadcast views need no
//     copy.
//   - oktopk_residual: one cb_residual launch over all W rows. Each input
//     is read once and the residual written once, with 16-byte streaming
//     loads and stores; the winner mask result != 0, the sent mask
//     |acc| >= lt[w] (lt unclamped), and both bf16 roundings live only in
//     registers. A row whose start is not 16-byte aligned takes up to 3
//     scalar head elements, a ragged tail up to 3 scalar ones (VGG-16's
//     bucket n is not a multiple of 4); inputs whose addresses differ
//     modulo 16 bytes take a scalar grid-stride loop.
//
// The arithmetic is the plain version's, operation for operation:
//   float32 wire: residual = result != 0 ? +0 : acc;
//   bf16 wire:    res  = result != 0 ? (|acc| >= lt ? acc - rnd(acc) : +0)
//                                    : acc
//                 comp = result != 0 && reduced != 0
//                        ? reduced - rnd(reduced) : +0
//                 residual = res + comp      (so -0.0 at a non-winner
//                                             becomes +0.0)
// rnd = round to bfloat16 (nearest, ties to even), back to float32. There
// is no multiplication, so no FMA contraction can arise. Built without
// --use_fast_math and without -ftz=true: the residual keeps subnormals,
// and NaN and infinities pass through the same IEEE operations as on the
// plain path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define VPT 4  // 16-byte quads a thread, all loads issued before any use

__global__ void __launch_bounds__(THREADS)
    cb_scatter(float* __restrict__ out, int64_t n,
               const float* __restrict__ val, const int* __restrict__ idx,
               int64_t cap, int64_t vw, int64_t vc, int64_t iw, int64_t ic) {
  const int64_t w = blockIdx.y;
  const int64_t c = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (c >= cap) return;
  const int i = idx[w * iw + c * ic];
  if (i < 0 || i >= n) return;  // the sentinel n drops
  atomicAdd(out + w * n + i, val[w * vw + c * vc]);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <bool BF16>
__device__ __forceinline__ float cb_elem(float a, float r, float d,
                                         float t) {
  const bool win = r != 0.0f;
  if (!BF16) return win ? 0.0f : a;
  const float res =
      win ? (fabsf(a) >= t ? __fsub_rn(a, bf16_round(a)) : 0.0f) : a;
  const float comp =
      (win && d != 0.0f) ? __fsub_rn(d, bf16_round(d)) : 0.0f;
  return __fadd_rn(res, comp);
}

template <bool BF16>
__device__ __forceinline__ float4 cb_quad(float4 a, float4 r, float4 d,
                                          float t) {
  return make_float4(cb_elem<BF16>(a.x, r.x, d.x, t),
                     cb_elem<BF16>(a.y, r.y, d.y, t),
                     cb_elem<BF16>(a.z, r.z, d.z, t),
                     cb_elem<BF16>(a.w, r.w, d.w, t));
}

template <bool BF16>
__global__ void __launch_bounds__(THREADS)
    cb_residual(const float* __restrict__ acc,
                const float* __restrict__ result,
                const float* __restrict__ reduced,
                const float* __restrict__ lt, float* __restrict__ out,
                int64_t n, int vec) {
  const int64_t base = (int64_t)blockIdx.y * n;
  const float* a = acc + base;
  const float* r = result + base;
  const float* d = reduced + base;
  float* o = out + base;
  const float t = lt[blockIdx.y];
  if (!vec) {
    for (int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x; i < n;
         i += (int64_t)gridDim.x * THREADS)
      o[i] = cb_elem<BF16>(a[i], r[i], BF16 ? d[i] : 0.0f, t);
    return;
  }
  // every input shares a's offset modulo 16 bytes (checked on the host)
  int64_t head = (4 - (int64_t)(((uintptr_t)a >> 2) & 3)) & 3;
  if (head > n) head = n;
  const int64_t nvec = (n - head) >> 2;
  if (blockIdx.x == 0 && threadIdx.x < 8) {
    const int k = threadIdx.x;
    const int64_t i = k < 4 ? k : head + 4 * nvec + (k - 4);
    if (k < 4 ? i < head : i < n)
      o[i] = cb_elem<BF16>(a[i], r[i], BF16 ? d[i] : 0.0f, t);
  }
  const float4* a4 = reinterpret_cast<const float4*>(a + head);
  const float4* r4 = reinterpret_cast<const float4*>(r + head);
  const float4* d4 = reinterpret_cast<const float4*>(d + head);
  float4* o4 = reinterpret_cast<float4*>(o + head);
  const int64_t v0 = (int64_t)blockIdx.x * (THREADS * VPT) + threadIdx.x;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float4 va[VPT], vr[VPT], vd[VPT];
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int64_t v = v0 + k * THREADS;
    va[k] = vr[k] = vd[k] = zero;
    if (v < nvec) {
      va[k] = __ldcs(a4 + v);
      vr[k] = __ldcs(r4 + v);
      if (BF16) vd[k] = __ldcs(d4 + v);
    }
  }
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int64_t v = v0 + k * THREADS;
    if (v < nvec) __stcs(o4 + v, cb_quad<BF16>(va[k], vr[k], vd[k], t));
  }
}

// out: [W, n] f32, written whole; val [W, R, cap] f32 and idx [W, R, cap]
// i32 read at element strides (vw, vr, vc) and (iw, ir, ic).
extern "C" int oktopk_scatter_rows(float* out, int64_t n, int W,
                                   const float* val, const int* idx, int R,
                                   int64_t cap, int64_t vw, int64_t vr,
                                   int64_t vc, int64_t iw, int64_t ir,
                                   int64_t ic, cudaStream_t stream) {
  if (n < 1 || n >= (1LL << 31) || W < 1 || W > 65535 || R < 0 || cap < 0)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e =
      cudaMemsetAsync(out, 0, (size_t)W * (size_t)n * sizeof(float), stream);
  if (e != cudaSuccess) return (int)e;
  if (cap > 0) {
    const dim3 grid((unsigned)((cap + THREADS - 1) / THREADS), (unsigned)W);
    for (int r = 0; r < R; ++r)
      cb_scatter<<<grid, THREADS, 0, stream>>>(
          out, n, val + (int64_t)r * vr, idx + (int64_t)r * ir, cap, vw, vc,
          iw, ic);
  }
  return (int)cudaGetLastError();
}

// acc, result, reduced, out: [W, n] f32 contiguous; lt: [W] f32. bf16: the
// wire rounds to bfloat16 (else float32, and reduced is not read).
extern "C" int oktopk_residual(const float* acc, const float* result,
                               const float* reduced, const float* lt,
                               float* out, int64_t n, int W, int bf16,
                               cudaStream_t stream) {
  if (n < 1 || W < 1 || W > 65535) return (int)cudaErrorInvalidValue;
  const uintptr_t al = (uintptr_t)acc & 15;
  const int vec = (al & 3) == 0 && ((uintptr_t)result & 15) == al &&
                  ((uintptr_t)out & 15) == al &&
                  (!bf16 || ((uintptr_t)reduced & 15) == al);
  const int64_t per_block = 4LL * THREADS * VPT;
  const dim3 grid((unsigned)((n + per_block - 1) / per_block), (unsigned)W);
  if (bf16)
    cb_residual<true><<<grid, THREADS, 0, stream>>>(acc, result, reduced, lt,
                                                    out, n, vec);
  else
    cb_residual<false><<<grid, THREADS, 0, stream>>>(acc, result, reduced,
                                                     lt, out, n, vec);
  return (int)cudaGetLastError();
}
