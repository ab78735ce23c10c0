// K2: all-pairs sphere self-collision cost and net workspace gradient.
//
// Replaces the Pallas TPU kernel or_cdchomp_tpu/ops/pallas_selfcol.py
// (_make_kernel / _selfcol_call / selfcol_pairs, dense variant), whose
// values the main path computed through the dense XLA form
// or_cdchomp_tpu/chomp/cost_soa.py:_selfcol_soa.  Per ordered pair
// (i active, j any sphere, not on the same link):
//
//   w1 = slope * obs_self * |v_i| / d
//   w2 = [|v_i| > 1e-6] * w1 * (v_i . (x_i - x_j)) / |v_i|^2
//   net_i += w1 (x_i - x_j) - w2 v_i,   net_j -= the same (j active)
//   cost_i += [d <= eps] * hinge(d) * obs_self * |v_i|
//
// What bounds it on the H100: occupancy and latency.  The flagship step
// evaluates 99 * 207 * 256 = 5.2 M pairs at ~45 flops each, which is
// nothing for the card, but there are only 99 * 256 = 25,344 threads
// (about 6 warps per SM), each walking the 207-pair list in sequence.
//
// What the design does about it: one thread per (moving point, problem),
// problem index fastest, so the SoA loads of a warp coalesce.  The pair
// list (i, j, r_i + r_j) is compacted once per engine from the same-link
// mask and sorted by i, so sphere i's position, speed and weights are
// loaded once per run of its pairs.  The per-sphere accumulators live in
// shared memory laid out [sphere*4 + component][thread], so the runtime
// pair indices never force a local-memory array, each thread touches only
// its own column (no atomics, no barriers, no bank conflicts), and the
// net_j -= update is a plain store.  Splitting the pair list across
// threads to raise occupancy is left for later work.
//
// The arithmetic is the Pallas body's: difference form |x_i - x_j|^2 (not
// the expanded form, which cancels in f32), rsqrt(max(d2, 1e-24)) for
// both 1/d and d, and the same accumulation order per sphere.

#include <cuda_runtime.h>
#include <math.h>

namespace {

__global__ void selfcol_kernel(const float* __restrict__ xi,
                               const float* __restrict__ vel,
                               const float* __restrict__ xo, int m, int Sa,
                               int SI, int B, const int* __restrict__ pair_i,
                               const int* __restrict__ pair_j,
                               const float* __restrict__ rsum, int P,
                               const float* __restrict__ eps_self,
                               const float* __restrict__ obs_self,
                               float* __restrict__ net,
                               float* __restrict__ cost) {
  extern __shared__ float accum[];   // [Sa * 4][blockDim.x]
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const long long t = (long long)blockIdx.x * nt + tid;
  if (t >= (long long)m * B) return;   // no barriers below
  const int k = (int)(t / B);
  const int b = (int)(t % B);
  const long long n = (long long)m * Sa * B;   // component stride of xi
  const long long no = (long long)SI * B;      // component stride of xo

  for (int r = 0; r < Sa * 4; ++r) accum[r * nt + tid] = 0.0f;

  const float e = eps_self[b];
  const float inv_e = 1.0f / e;
  const float ofs = obs_self[b];

  int cur = -1;
  float x0 = 0.f, x1 = 0.f, x2 = 0.f, v0 = 0.f, v1 = 0.f, v2 = 0.f;
  float ofv = 0.f, iv2 = 0.f;
  bool safe = false;
  for (int p = 0; p < P; ++p) {
    const int i = pair_i[p];
    const int j = pair_j[p];
    const float rs = rsum[p];
    if (i != cur) {
      cur = i;
      const long long at = ((long long)k * Sa + i) * B + b;
      x0 = xi[at];
      x1 = xi[n + at];
      x2 = xi[2 * n + at];
      v0 = vel[at];
      v1 = vel[n + at];
      v2 = vel[2 * n + at];
      const float vv = v0 * v0 + v1 * v1 + v2 * v2;
      const float vn = sqrtf(vv);
      safe = vn > 1e-6f;
      iv2 = safe ? 1.0f / vv : 0.0f;
      ofv = ofs * vn;
    }
    float y0, y1, y2;
    if (j < Sa) {
      const long long at = ((long long)k * Sa + j) * B + b;
      y0 = xi[at];
      y1 = xi[n + at];
      y2 = xi[2 * n + at];
    } else {
      const long long at = (long long)(j - Sa) * B + b;
      y0 = xo[at];
      y1 = xo[no + at];
      y2 = xo[2 * no + at];
    }
    const float d0 = x0 - y0, d1 = x1 - y1, d2 = x2 - y2;
    const float dd = d0 * d0 + d1 * d1 + d2 * d2;
    const float inv_cd = rsqrtf(fmaxf(dd, 1e-24f));
    const float cd = dd * inv_cd;
    const float d = cd - rs;
    const bool ok = d <= e;
    const float de = d - e;
    const float c_h = d < 0.0f ? 0.5f * e - d : 0.5f * de * de * inv_e;
    const float cost_pair = (ok ? c_h : 0.0f) * ofv;
    const float slope = d < 0.0f ? -1.0f : d * inv_e - 1.0f;
    const float w1 = ok ? slope * ofv * inv_cd : 0.0f;
    const float bv = v0 * d0 + v1 * d1 + v2 * d2;
    const float w2 = safe ? w1 * bv * iv2 : 0.0f;
    accum[(i * 4 + 3) * nt + tid] += cost_pair;
    const float g0 = w1 * d0 - w2 * v0;
    const float g1 = w1 * d1 - w2 * v1;
    const float g2 = w1 * d2 - w2 * v2;
    accum[(i * 4 + 0) * nt + tid] += g0;
    accum[(i * 4 + 1) * nt + tid] += g1;
    accum[(i * 4 + 2) * nt + tid] += g2;
    if (j < Sa) {
      accum[(j * 4 + 0) * nt + tid] -= g0;
      accum[(j * 4 + 1) * nt + tid] -= g1;
      accum[(j * 4 + 2) * nt + tid] -= g2;
    }
  }

  for (int s = 0; s < Sa; ++s) {
    const long long at = ((long long)k * Sa + s) * B + b;
    net[at] = accum[(s * 4 + 0) * nt + tid];
    net[n + at] = accum[(s * 4 + 1) * nt + tid];
    net[2 * n + at] = accum[(s * 4 + 2) * nt + tid];
    cost[at] = accum[(s * 4 + 3) * nt + tid];
  }
}

constexpr int kMaxStaticShared = 48 * 1024;

}  // namespace

extern "C" int cdx_selfcol(const float* xi, const float* vel, const float* xo,
                           int m, int Sa, int SI, int B, const int* pair_i,
                           const int* pair_j, const float* rsum, int P,
                           const float* eps_self, const float* obs_self,
                           float* net, float* cost, void* stream) {
  long long threads = (long long)m * B;
  if (threads == 0 || Sa == 0) return 0;
  // the largest block (<= 128 threads) whose accumulators fit the default
  // 48 KB of dynamic shared memory
  int nt = 128;
  while (nt > 32 && (size_t)Sa * 4 * nt * sizeof(float) > kMaxStaticShared)
    nt /= 2;
  size_t smem = (size_t)Sa * 4 * nt * sizeof(float);
  if (smem > kMaxStaticShared) return (int)cudaErrorInvalidConfiguration;
  int blocks = (int)((threads + nt - 1) / nt);
  selfcol_kernel<<<blocks, nt, smem, (cudaStream_t)stream>>>(
      xi, vel, xo, m, Sa, SI, B, pair_i, pair_j, rsum, P, eps_self, obs_self,
      net, cost);
  return (int)cudaGetLastError();
}
