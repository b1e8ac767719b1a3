// JAX's Bernoulli keep mask for Hopper (sm_90a): threefry2x32-20.
//
// No TPU kernel corresponds to it: XLA emits JAX's threefry behind flax's
// nn.Dropout. It replaces jax.random.bernoulli(key, keep_prob, shape) in
// ops/prng.py::keep_mask, bit for bit: element i (flat, row-major) runs
// threefry2x32-20 under the key (k0, k1) on the counter pair
// (c >> 32, c & 0xffffffff), c = offset + i; the mask bit is
//   u = float32((x0 ^ x1) >> 9 | 0x3F800000) - 1.0f,  out[i] = u < keep_prob.
// The key is two kernel arguments, read on the host from numpy: no host
// sync, no key tensor.
//
// What bounds it: integer operations. Each element takes some 75 32-bit
// integer operations (20 rounds of add, rotate and xor, five key
// injections) and writes one byte, so at the INT32 rate (132 SMs x 64
// lanes x 1.98 GHz, about 16.7 TOP/s) it needs ~4.5 ps an element against
// 0.3 ps for its byte at 3.35 TB/s. One thread an element, a grid-stride
// loop; rotations are __funnelshift_l (one SHF each).
//
// Built without --use_fast_math: the subtract and compare are IEEE
// float32, as in the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

#define ROUND(r)          \
  x0 += x1;               \
  x1 = rotl(x1, r) ^ x0;

__global__ void keep_mask_kernel(uint32_t k0, uint32_t k1, uint64_t offset,
                                 int64_t n, float keep_prob,
                                 bool* __restrict__ out) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const uint64_t c = offset + (uint64_t)i;
    uint32_t x0 = (uint32_t)(c >> 32) + k0;
    uint32_t x1 = (uint32_t)c + k1;
    ROUND(13) ROUND(15) ROUND(26) ROUND(6)
    x0 += k1; x1 += k2 + 1u;
    ROUND(17) ROUND(29) ROUND(16) ROUND(24)
    x0 += k2; x1 += k0 + 2u;
    ROUND(13) ROUND(15) ROUND(26) ROUND(6)
    x0 += k0; x1 += k1 + 3u;
    ROUND(17) ROUND(29) ROUND(16) ROUND(24)
    x0 += k1; x1 += k2 + 4u;
    ROUND(13) ROUND(15) ROUND(26) ROUND(6)
    x0 += k2; x1 += k0 + 5u;
    const uint32_t bits = x0 ^ x1;
    const float u = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
    out[i] = u < keep_prob;
  }
}

extern "C" int oktopk_keep_mask(uint32_t k0, uint32_t k1, uint64_t offset,
                                int64_t n, float keep_prob, bool* out,
                                cudaStream_t stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  int64_t blocks = (n + THREADS - 1) / THREADS;
  // enough blocks to fill the card many times over; the loop takes the rest
  if (blocks > 132 * 64) blocks = 132 * 64;
  keep_mask_kernel<<<(unsigned)blocks, THREADS, 0, stream>>>(
      k0, k1, offset, n, keep_prob, out);
  return (int)cudaGetLastError();
}
