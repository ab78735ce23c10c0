// K1: fused SDF obstacle cost and workspace gradient for the batched
// CHOMP step.
//
// Replaces the Pallas TPU kernel or_cdchomp_tpu/ops/pallas_sdf.py
// (_kernel / sdf_cell_lookup: the 4-cell one-sided lookup of libcd,
// grid.c:331-454) together with the XLA code around it on the main path,
// or_cdchomp_tpu/chomp/cost_soa.py:_obstacle_soa (subscripts, lookup,
// interpolation and gradient, field min-select, hinge cost, velocity
// projection and curvature term).
//
// What bounds it on the H100: memory traffic and latency, not arithmetic.
// Each (point, sphere, problem) query reads x, vel, acc (36 B) and writes
// the cost and the 3-component gradient (16 B): about 52 B per query, some
// 20 MB per step at the flagship shape (m=99, S=15, B=256), against ~200
// flops per query per field.  The field itself is small (12x16x12 f32,
// 9 KB) and stays in L1/L2.
//
// What the design does about it: one thread per query with the problem
// index fastest, so every SoA load and store of a warp is one coalesced
// 128-byte transaction; the whole per-query pipeline is fused, so no
// intermediate (subscripts, cell values, per-field values) ever goes to
// device memory; the 4 cells are read through the read-only cache
// (__ldg).  Staging the field in shared memory is left for later work.
//
// Numerics: the one-sided neighbour choice compares p >= (s + 0.5)/size *
// length.  A query on a cell centre flips its neighbour (and the sign of
// that gradient axis) if any product or sum rounds differently from the
// plain PyTorch version, so the library is built with -fmad=false and
// every expression keeps the operation order of cost_soa.py.  True +-inf
// marks "not contained" cells (the TPU path needed a finite stand-in only
// for its matmul lookup).

#include <cuda_runtime.h>
#include <math.h>

namespace {

struct Cells4 {
  float v0, vx, vy, vz;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// The 4 cells of one field slab (mx, my, mz): centre (sx, sy, sz) and
// the per-axis neighbours (nx, sy, sz), (sx, ny, sz), (sx, sy, nz).
// Subscripts are clamped to the slab so no read leaves it.
__device__ __forceinline__ Cells4 lookup4(const float* __restrict__ slab,
                                          int mx, int my, int mz, int sx,
                                          int sy, int sz, int nx, int ny,
                                          int nz) {
  sx = clampi(sx, 0, mx - 1);
  sy = clampi(sy, 0, my - 1);
  sz = clampi(sz, 0, mz - 1);
  nx = clampi(nx, 0, mx - 1);
  ny = clampi(ny, 0, my - 1);
  nz = clampi(nz, 0, mz - 1);
  Cells4 c;
  c.v0 = __ldg(slab + (sx * my + sy) * mz + sz);
  c.vx = __ldg(slab + (nx * my + sy) * mz + sz);
  c.vy = __ldg(slab + (sx * my + ny) * mz + sz);
  c.vz = __ldg(slab + (sx * my + sy) * mz + nz);
  return c;
}

// v' = v + w*t + q x t with t = 2 (q x v)  (ops/soa.py qrot, same order)
__device__ __forceinline__ void qrot(float qx, float qy, float qz, float qw,
                                     float vx, float vy, float vz, float* o) {
  float tx = (qy * vz - qz * vy) * 2.0f;
  float ty = (qz * vx - qx * vz) * 2.0f;
  float tz = (qx * vy - qy * vx) * 2.0f;
  o[0] = (vx + tx * qw) + (qy * tz - qz * ty);
  o[1] = (vy + ty * qw) + (qz * tx - qx * tz);
  o[2] = (vz + tz * qw) + (qx * ty - qy * tx);
}

__global__ void sdf_cell_lookup_kernel(const float* __restrict__ data, int F,
                                       int mx, int my, int mz,
                                       const int* __restrict__ sub,
                                       const int* __restrict__ nbr, int Q,
                                       float* __restrict__ out) {
  long long n = (long long)F * Q;
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  int f = (int)(t / Q);
  const int* s = sub + 3 * t;
  const int* nb = nbr + 3 * t;
  Cells4 c = lookup4(data + (long long)f * mx * my * mz, mx, my, mz, s[0],
                     s[1], s[2], nb[0], nb[1], nb[2]);
  out[t] = c.v0;
  out[n + t] = c.vx;
  out[2 * n + t] = c.vy;
  out[3 * n + t] = c.vz;
}

__global__ void obstacle_kernel(
    const float* __restrict__ x, const float* __restrict__ vel,
    const float* __restrict__ acc, int m, int S, int B,
    const float* __restrict__ data, int F, int mx, int my, int mz,
    const int* __restrict__ sizes, const float* __restrict__ lengths,
    const float* __restrict__ pose_gw, const float* __restrict__ pose_wg,
    const unsigned char* __restrict__ enabled,
    const float* __restrict__ radii, const float* __restrict__ eps,
    const float* __restrict__ obs_factor, float* __restrict__ cost,
    float* __restrict__ wgrad, int* __restrict__ dirs) {
  const long long n = (long long)m * S * B;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const int b = (int)(t % B);
  const int s = (int)((t / B) % S);

  const float xw0 = x[t], xw1 = x[n + t], xw2 = x[2 * n + t];
  const float v0 = vel[t], v1 = vel[n + t], v2 = vel[2 * n + t];
  const float a0 = acc[t], a1 = acc[n + t], a2 = acc[2 * n + t];

  float best_v = INFINITY;
  float bg[3] = {0.0f, 0.0f, 0.0f};
  for (int f = 0; f < F; ++f) {
    const float* pg = pose_gw + ((long long)b * F + f) * 7;
    float p[3];
    qrot(pg[3], pg[4], pg[5], pg[6], xw0, xw1, xw2, p);
    p[0] = p[0] + pg[0];
    p[1] = p[1] + pg[1];
    p[2] = p[2] + pg[2];

    bool in_b = true;
    int sub[3], nb[3];
    float ctr[3], szf[3], ln[3];
    bool un[3];
    for (int i = 0; i < 3; ++i) {
      const int sz = sizes[3 * f + i];
      ln[i] = lengths[3 * f + i];
      szf[i] = (float)sz;
      const float xi = p[i] / ln[i];
      in_b = in_b && (xi >= 0.0f) && (xi <= 1.0f);
      // clamp in float before the cast: same result as the reference's
      // int clip for every finite value, and no undefined conversion
      float fl = floorf(xi * szf[i]);
      fl = fminf(fmaxf(fl, 0.0f), szf[i] - 1.0f);
      const int si = (int)fl;
      const float ci = ((float)si + 0.5f) / szf[i] * ln[i];
      bool u = p[i] >= ci;
      if (si == 0) u = true;
      if (si == sz - 1) u = false;
      sub[i] = si;
      nb[i] = si + (u ? 1 : -1);
      ctr[i] = ci;
      un[i] = u;
    }
    if (dirs) {
      dirs[f * n + t] = (un[0] ? 1 : 0) | (un[1] ? 2 : 0) | (un[2] ? 4 : 0);
    }

    const Cells4 c = lookup4(data + (long long)f * mx * my * mz, mx, my, mz,
                             sub[0], sub[1], sub[2], nb[0], nb[1], nb[2]);
    const float vn[3] = {c.vx, c.vy, c.vz};
    bool any_inf = isinf(c.v0) || isinf(c.vx) || isinf(c.vy) || isinf(c.vz);
    float value = c.v0;
    float g[3];
    for (int i = 0; i < 3; ++i) {
      const float sign = un[i] ? 1.0f : -1.0f;
      g[i] = sign * (vn[i] - c.v0) * (szf[i] / ln[i]);
      value = value + g[i] * (p[i] - ctr[i]);
    }
    const bool bad = !in_b || any_inf || !enabled[(long long)b * F + f];
    if (bad) {
      value = INFINITY;
      g[0] = g[1] = g[2] = 0.0f;
    }
    // gradient to world per field, before the min-select
    const float* pw = pose_wg + ((long long)b * F + f) * 7;
    float gw[3];
    qrot(pw[3], pw[4], pw[5], pw[6], g[0], g[1], g[2], gw);
    if (f == 0 || value < best_v) {   // strict: the first field wins ties
      best_v = value;
      bg[0] = gw[0];
      bg[1] = gw[1];
      bg[2] = gw[2];
    }
  }

  // hinge cost scaled by workspace speed (cost_soa.py:205-232)
  const bool has_field = isfinite(best_v);
  const float dist = has_field ? best_v : 0.0f;
  const float d = dist - radii[s];
  const float e = eps[b];
  const float of = obs_factor[b];
  const float vv = v0 * v0 + v1 * v1 + v2 * v2;
  const float vnorm = sqrtf(vv);
  const float c_in = of * (0.5f * e - d);
  const float dm = d - e;
  const float c_mid = of * (0.5f / e) * (dm * dm);
  float cs = vnorm * (d < 0.0f ? c_in : (d < e ? c_mid : 0.0f));
  cs = has_field ? cs : 0.0f;
  const float slope = d < 0.0f ? -1.0f : (d < e ? d / e - 1.0f : 0.0f);
  const float sc = has_field ? slope * vnorm * of : 0.0f;
  float gx = bg[0] * sc, gy = bg[1] * sc, gz = bg[2] * sc;

  // projection off the velocity + curvature (orcdchomp_mod.cpp:1225-1241)
  const bool safe = vnorm > 1e-6f;
  const float v2s = safe ? vv : 1.0f;
  const float proj = safe ? (gx * v0 + gy * v1 + gz * v2) / v2s : 0.0f;
  gx = gx - v0 * proj;
  gy = gy - v1 * proj;
  gz = gz - v2 * proj;
  const float aproj = safe ? (a0 * v0 + a1 * v1 + a2 * v2) / v2s : 0.0f;
  const float inv = safe ? 1.0f / v2s : 0.0f;
  const float cx = (a0 - v0 * aproj) * inv;
  const float cy = (a1 - v1 * aproj) * inv;
  const float cz = (a2 - v2 * aproj) * inv;
  gx = gx - cx * cs;
  gy = gy - cy * cs;
  gz = gz - cz * cs;

  cost[t] = cs;
  wgrad[t] = gx * vnorm;
  wgrad[n + t] = gy * vnorm;
  wgrad[2 * n + t] = gz * vnorm;
}

constexpr int kThreads = 256;

}  // namespace

extern "C" int cdx_sdf_cell_lookup(const float* data, int F, int mx, int my,
                                   int mz, const int* sub, const int* nbr,
                                   int Q, float* out, void* stream) {
  long long n = (long long)F * Q;
  if (n == 0) return 0;
  int blocks = (int)((n + kThreads - 1) / kThreads);
  sdf_cell_lookup_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      data, F, mx, my, mz, sub, nbr, Q, out);
  return (int)cudaGetLastError();
}

extern "C" int cdx_obstacle(const float* x, const float* vel, const float* acc,
                            int m, int S, int B, const float* data, int F,
                            int mx, int my, int mz, const int* sizes,
                            const float* lengths, const float* pose_gw,
                            const float* pose_wg, const unsigned char* enabled,
                            const float* radii, const float* eps,
                            const float* obs_factor, float* cost, float* wgrad,
                            int* dirs, void* stream) {
  long long n = (long long)m * S * B;
  if (n == 0) return 0;
  int blocks = (int)((n + kThreads - 1) / kThreads);
  obstacle_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      x, vel, acc, m, S, B, data, F, mx, my, mz, sizes, lengths, pose_gw,
      pose_wg, enabled, radii, eps, obs_factor, cost, wgrad, dirs);
  return (int)cudaGetLastError();
}
