// Per-problem HMC draws from Philox4x32-10, one launch per step.
//
// No TPU kernel is replaced: the JAX package draws with jax.random from a
// key per problem, split every step (or_cdchomp_tpu/chomp/solver.py:
// 263-274).  Here problem b at its iteration it draws from Philox4x32-10
// (Salmon, Moraes, Dror, Shaw, SC'11; the Random123 constants) keyed by its
// 64-bit seed, at the counters (j, it, stream, 0):
//
//   stream 0, j < ceil(m n / 4): words (w0, w1, w2, w3) -> the normals
//     z[4j .. 4j+3] by Box-Muller, r = sqrt(-2 ln((w + 1) 2^-32)),
//     theta = 2 pi w' 2^-32, (w0, w1) -> r cos, r sin, (w2, w3) likewise;
//   stream 1, j = 0: word 0 -> u = 1e-12 + (1 - 1e-12) w 2^-32.
//
// So a problem's draws depend on its seed and its own iteration only, not
// on its batch or its row.  The plain version is or_cdchomp_tpu_torch/ops/
// draw.py (hmc_draw_ref): the same integer rounds, and the same float64
// transforms in the same order (built with -fmad=false: no contraction),
// then one cast to the output type.
//
// One thread per (problem, counter): B (ceil(m n / 4) + 1) threads.  The
// work is a few hundred integer operations and four float64 transcendental
// calls per thread; the bound is the bytes written (z and u), 4 or 8 per
// value.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kM0 = 0xD2511F53u;
constexpr uint32_t kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u;
constexpr uint32_t kW1 = 0xBB67AE85u;
constexpr double kTwoM32 = 2.3283064365386963e-10;   // 2^-32
constexpr double kTwoPi = 6.283185307179586;          // float64(2 pi)
constexpr double kUMin = 1e-12;
constexpr int kThreads = 256;

__device__ __forceinline__ void philox4x32_10(uint32_t c[4], uint32_t k0,
                                              uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += kW0;
      k1 += kW1;
    }
    const uint32_t hi0 = __umulhi(kM0, c[0]);
    const uint32_t lo0 = kM0 * c[0];
    const uint32_t hi1 = __umulhi(kM1, c[2]);
    const uint32_t lo1 = kM1 * c[2];
    const uint32_t x0 = hi1 ^ c[1] ^ k0;
    const uint32_t x2 = hi0 ^ c[3] ^ k1;
    c[0] = x0;
    c[1] = lo1;
    c[2] = x2;
    c[3] = lo0;
  }
}

template <typename T>
__device__ __forceinline__ T below_one();
template <>
__device__ __forceinline__ float below_one<float>() {
  return __int_as_float(0x3f7fffff);
}
template <>
__device__ __forceinline__ double below_one<double>() {
  return __longlong_as_double(0x3fefffffffffffffLL);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    hmc_draw_kernel(const int64_t* __restrict__ seed,
                    const int* __restrict__ iteration, int B, int mn, int J,
                    T* __restrict__ z, T* __restrict__ u,
                    int* __restrict__ words) {
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t per = (int64_t)J + 1;
  if (t >= (int64_t)B * per) return;
  const int b = (int)(t / per);
  const int j = (int)(t - (int64_t)b * per);
  const uint64_t s = (uint64_t)seed[b];
  const bool is_u = j == J;
  uint32_t c[4] = {is_u ? 0u : (uint32_t)j, (uint32_t)iteration[b],
                   is_u ? 1u : 0u, 0u};
  philox4x32_10(c, (uint32_t)(s & 0xffffffffu), (uint32_t)(s >> 32));
  if (words != nullptr) {
    int* w = words + t * 4;
    for (int q = 0; q < 4; ++q) w[q] = (int)c[q];
  }
  if (is_u) {
    const double v = kUMin + (1.0 - kUMin) * ((double)c[0] * kTwoM32);
    const T out = (T)v;
    u[b] = out < below_one<T>() ? out : below_one<T>();
    return;
  }
  T* zb = z + (int64_t)b * mn;
  const int e0 = 4 * j;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const double u1 = ((double)c[2 * h] + 1.0) * kTwoM32;
    const double theta = kTwoPi * ((double)c[2 * h + 1] * kTwoM32);
    const double r = sqrt(-2.0 * log(u1));
    const int e = e0 + 2 * h;
    if (e < mn) zb[e] = (T)(r * cos(theta));
    if (e + 1 < mn) zb[e + 1] = (T)(r * sin(theta));
  }
}

}  // namespace

// dtype: 0 float32, 1 float64.  words, when not null, receives the four
// words of every (problem, counter), (B, J + 1, 4) with J = ceil(mn / 4).
extern "C" int cdx_hmc_draw(const int64_t* seed, const int* iteration, int B,
                            int mn, int dtype, void* z, void* u, int* words,
                            void* stream) {
  if (B == 0) return 0;
  const int J = (mn + 3) / 4;
  const int64_t total = (int64_t)B * (J + 1);
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    hmc_draw_kernel<float><<<(unsigned)blocks, kThreads, 0, st>>>(
        seed, iteration, B, mn, J, (float*)z, (float*)u, words);
  } else if (dtype == 1) {
    hmc_draw_kernel<double><<<(unsigned)blocks, kThreads, 0, st>>>(
        seed, iteration, B, mn, J, (double*)z, (double*)u, words);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
