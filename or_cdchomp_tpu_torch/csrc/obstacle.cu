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
// What bounds it on the H100: memory traffic, once the instructions are
// few enough.  Each (point, sphere, problem) query reads x, vel, acc
// (36 B) and writes the cost and the 3-component gradient (16 B): about
// 52 B per query, some 20 MB per call at the flagship shape (m=99, S=15,
// B=256), 5.9 us at 3.35 TB/s, whatever the number of fields F.  The
// field stack is small (9-28 KB) and stays in L1/L2.
//
// What held the first design back (one thread per query, 0.0116 ms at
// F = 1 and 0.0210 ms at F = 3): instruction issue.  Each query ran two
// 64-bit integer divisions for its (sphere, problem) index, nine IEEE
// divisions per field of which six depend only on the field, 14 pose
// loads per field from a (B, F, 7) layout that a warp reads 28F bytes
// apart, a world rotation of every field's gradient, and the subscripts,
// the four cell reads and the gradient also for queries outside the
// field's box.
//
// What this design does about it:
//  - A block is kLanes = 32 consecutive problems in its lanes (every
//    load and store of x, vel, acc, cost and wgrad is one 128-byte line
//    per warp) and walks a range of (point, sphere) rows, each warp
//    every W-th row.  The grid is one wave: launch_geometry in
//    ops/sdf_lookup.py splits the (tile, row) space evenly over the
//    blocks that fit on the SMs at once.  Indices are 32-bit; divisions
//    by a runtime value run once per block segment, not per query.
//  - Staging, once per tile of 32 problems: both poses and
//    field_enabled as float4 rows per (field, lane) in shared memory, so
//    a lane reads a field's pose in two conflict-free 16-byte loads.
//    Once per block, the last warp computes per field the size, length,
//    size / length and a table of cell centres (s + 0.5) / size * length
//    with obstacle_ref's very expressions, while the other warps stage
//    the poses: their memory round trips overlap.  A thread keeps its
//    problem's epsilon, obs_factor and 0.5 / epsilon for all its rows,
//    and loads the next row's x while it computes the current one.
//  - Per field, only p / length stays a division, and on the main path
//    (no dirs) not even that for a query certainly outside the box: p
//    below -1e-6 * length or above 1.0001 * length makes p / length < 0
//    or > 1 in any rounding, so the query skips its subscripts, cells
//    and gradient (value +inf, gradient 0), as it does on a disabled
//    field.  A query inside reads its four cells through __ldg.  Only
//    the winning field's gradient is rotated to world, after the
//    min-select.
//  - __launch_bounds__ holds the kernel to kMinBlocks = 3 resident
//    blocks of 256 threads per SM (at most 80 registers), with no
//    spills.  Copying the stack to shared memory at block start was
//    slower than reading it through L1 at every measured shape
//    (PERF.md), and was dropped.
//
// Numerics: the one-sided neighbour choice compares p >= (s + 0.5)/size *
// length.  A query on a cell centre flips its neighbour (and the sign of
// that gradient axis) if any product or sum rounds differently from the
// plain PyTorch version, so the library is built with -fmad=false and
// every expression keeps the operation order of cost_soa.py; the hoisted
// constants are computed with the same expressions, so the kernel stays
// bit-equal to obstacle_ref.  The field min-select keeps strict
// first-wins ties.  True +-inf marks "not contained" cells (the TPU path
// needed a finite stand-in only for its matmul lookup).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kLanes = 32;     // problems per warp, and per block tile
constexpr int kThreads = 256;  // threads per block (launch_geometry)
constexpr int kMinBlocks = 3;  // resident blocks per SM the registers allow

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

// ---- the obstacle kernel -----------------------------------------------------

// 32-bit words of a block's shared memory: per field and lane the pose
// pose_gsdf_world as (qx, qy, qz, qw), (tx, ty, tz, enabled) and the
// rotation of pose_world_gsdf as (qx, qy, qz, qw); per field five rows
// of (x, y, z, -) constants: size, length, size / length and the two
// bounds of the division-free box pre-test; the cell centres
// [F][mx + my + mz].  ops/sdf_lookup.py:smem_bytes counts the same, and
// a GPU test holds it to cdx_obstacle_smem_bytes below.
int smem_words(int F, int mx, int my, int mz) {
  return 4 * 3 * F * kLanes + 4 * 5 * F + F * (mx + my + mz);
}

// One thread per problem lane; a block walks units [blockIdx.x * per,
// +per) of the (tile, row) space, tile-major, with rows = m * S and
// units = ceil(B / kLanes) * rows.  Query (row r, problem b) is element
// t = r * B + b of every (., m, S, B) array.
__global__ void __launch_bounds__(kThreads, kMinBlocks) obstacle_kernel(
    const float* __restrict__ x, const float* __restrict__ vel,
    const float* __restrict__ acc, int S, int B, int rows, int units,
    int per, const float* __restrict__ data, int F, int mx, int my, int mz,
    const int* __restrict__ sizes, const float* __restrict__ lengths,
    const float* __restrict__ pose_gw, const float* __restrict__ pose_wg,
    const unsigned char* __restrict__ enabled,
    const float* __restrict__ radii, const float* __restrict__ eps,
    const float* __restrict__ obs_factor, float* __restrict__ cost,
    float* __restrict__ wgrad, int* __restrict__ dirs) {
  extern __shared__ __align__(16) float4 smem4[];
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int lane = tid % kLanes;
  const int warp = tid / kLanes;
  const int W = nthr / kLanes;
  const int n = rows * B;
  const int mxyz = mx * my * mz;
  const int ncell = mx + my + mz;
  float4* s_pg = smem4;                    // [F][2][kLanes]
  float4* s_pw = s_pg + 2 * F * kLanes;    // [F][kLanes]
  float4* s_fc = s_pw + F * kLanes;        // [F][5]
  float* s_ctr = reinterpret_cast<float*>(s_fc + 5 * F);
  float* pg_f = reinterpret_cast<float*>(s_pg);
  float* pw_f = reinterpret_cast<float*>(s_pw);
  float* fc_f = reinterpret_cast<float*>(s_fc);
  const float* x1 = x + n;
  const float* x2 = x1 + n;
  const float* v1p = vel + n;
  const float* v2p = v1p + n;
  const float* a1p = acc + n;
  const float* a2p = a1p + n;
  float* wg1 = wgrad + n;
  float* wg2 = wg1 + n;
  const int sstep = W % S;
  // staged per tile: 7 pose components and field_enabled per (field, lane)
  const int nstage = F * 8 * kLanes;
  const int nstager = nthr - kLanes;       // the last warp stages constants

  int u = blockIdx.x * per;
  const int u_end = min(u + per, units);
  bool first = true;
  while (u < u_end) {                       // block-uniform
    const int tile = u / rows;
    const int r_lo = u - tile * rows;
    const int r_hi = min(rows, r_lo + (u_end - u));
    u += r_hi - r_lo;
    const int b0 = tile * kLanes;
    const int nb = min(kLanes, B - b0);
    const int b = b0 + lane;
    const bool live = lane < nb;

    // this thread's first row, loaded before the staging barrier
    int r = r_lo + warp;
    float cx0 = 0.f, cx1 = 0.f, cx2 = 0.f;
    if (live && r < r_hi) {
      const int t = r * B + b;
      cx0 = __ldg(x + t), cx1 = __ldg(x1 + t), cx2 = __ldg(x2 + t);
    }
    const float e_b = live ? __ldg(eps + b) : 1.0f;
    const float of_b = live ? __ldg(obs_factor + b) : 0.0f;
    const float half_inv_e = 0.5f / e_b;    // obstacle_ref: 0.5 / eps

    // the staging warps overlap their loads with the constant warp's
    if (!first) __syncthreads();   // the last tile's data is no longer read
    if (tid < nstager) {
      // both poses and field_enabled of this tile, element e = (f * 8 +
      // component) * kLanes + lane (component 7: enabled); up to four
      // elements a thread, their loads issued before the stores
      for (int e0 = tid; e0 < nstage; e0 += 4 * nstager) {
        float vg[4], vw[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int e = e0 + k * nstager;
          const int bl = e % kLanes, fc = e / kLanes;
          const int f = fc / 8, c = fc - 8 * f;
          vg[k] = 0.0f;
          vw[k] = 0.0f;
          if (e < nstage && bl < nb) {
            if (c < 7) {
              const int g = ((b0 + bl) * F + f) * 7 + c;
              vg[k] = __ldg(pose_gw + g);
              vw[k] = __ldg(pose_wg + g);
            } else {
              vg[k] = enabled[(b0 + bl) * F + f] ? 1.0f : 0.0f;
            }
          }
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int e = e0 + k * nstager;
          const int bl = e % kLanes, fc = e / kLanes;
          const int f = fc / 8, c = fc - 8 * f;
          if (e >= nstage || bl >= nb) continue;
          // (qx, qy, qz, qw) in row 0, (tx, ty, tz, enabled) in row 1
          const int row = (c < 3 || c == 7) ? 1 : 0;
          const int j = c < 3 ? c : (c == 7 ? 3 : c - 3);
          pg_f[((2 * f + row) * kLanes + bl) * 4 + j] = vg[k];
          if (c >= 3 && c < 7) pw_f[(f * kLanes + bl) * 4 + j] = vw[k];
        }
      }
    } else if (first) {
      // per-field constants and cell centres, with obstacle_ref's
      // expressions: szf / ln and (si + 0.5) / szf * ln
      const int tc = tid - nstager;
      for (int e = tc; e < 3 * F; e += kLanes) {
        const int f = e / 3, i = e - 3 * f;
        const float szf = (float)sizes[e];
        const float ln = lengths[e];
        const bool pos = ln > 0.0f && ln < INFINITY;
        fc_f[(5 * f + 0) * 4 + i] = szf;
        fc_f[(5 * f + 1) * 4 + i] = ln;
        fc_f[(5 * f + 2) * 4 + i] = szf / ln;
        // p below lo or above hi makes p / ln < 0 or > 1 for certain
        fc_f[(5 * f + 3) * 4 + i] = pos ? -ln * 1e-6f : -INFINITY;
        fc_f[(5 * f + 4) * 4 + i] = pos ? ln * 1.0001f : INFINITY;
      }
#pragma unroll 4
      for (int e = tc; e < F * ncell; e += kLanes) {
        const int f = e / ncell, c = e - f * ncell;
        const int i = c < mx ? 0 : (c < mx + my ? 1 : 2);
        const int si = c - (i == 0 ? 0 : (i == 1 ? mx : mx + my));
        const float szf = (float)__ldg(sizes + 3 * f + i);
        s_ctr[e] = ((float)si + 0.5f) / szf * __ldg(lengths + 3 * f + i);
      }
    }
    first = false;
    __syncthreads();

    int s = r % S;
    for (; r < r_hi; r += W) {               // warp-uniform
      const int t = r * B + b;
      const int rn = r + W;
      // this row's vel and acc, first needed after the field loop, and
      // the next row's x
      float cv0 = 0.f, cv1 = 0.f, cv2 = 0.f, ca0 = 0.f, ca1 = 0.f, ca2 = 0.f;
      float nx0 = 0.f, nx1 = 0.f, nx2 = 0.f;
      if (live) {
        cv0 = __ldg(vel + t), cv1 = __ldg(v1p + t), cv2 = __ldg(v2p + t);
        ca0 = __ldg(acc + t), ca1 = __ldg(a1p + t), ca2 = __ldg(a2p + t);
        if (rn < r_hi) {
          const int tn = rn * B + b;
          nx0 = __ldg(x + tn), nx1 = __ldg(x1 + tn), nx2 = __ldg(x2 + tn);
        }
      }

      if (live) {
        // -- the field min-select (cost_soa.py:_obstacle_soa) --------------
        float best_v = INFINITY;
        float g0 = 0.0f, g1 = 0.0f, g2 = 0.0f;
        int win = -1;                      // -1: no field contains the query
        const float* ctr = s_ctr;
        const float* slab = data;
        int* dp = dirs;
        for (int f = 0; f < F; ++f, ctr += ncell, slab += mxyz) {
          const float4 q = s_pg[(2 * f) * kLanes + lane];
          const float4 tr = s_pg[(2 * f + 1) * kLanes + lane];
          float p[3];
          qrot(q.x, q.y, q.z, q.w, cx0, cx1, cx2, p);
          p[0] = p[0] + tr.x;
          p[1] = p[1] + tr.y;
          p[2] = p[2] + tr.z;
          const float4* fc = s_fc + 5 * f;
          if (!dirs) {
            // outside the box for certain, or disabled: +inf, no gradient
            const float4 lo = fc[3], hi = fc[4];
            if (tr.w == 0.0f || p[0] < lo.x || p[0] > hi.x || p[1] < lo.y ||
                p[1] > hi.y || p[2] < lo.z || p[2] > hi.z)
              continue;
          }
          const float4 szv = fc[0], lnv = fc[1], rtv = fc[2];
          const float szf[3] = {szv.x, szv.y, szv.z};
          const float ln[3] = {lnv.x, lnv.y, lnv.z};
          const float ratio[3] = {rtv.x, rtv.y, rtv.z};
          bool in_b = true;
          int sub[3], nbr[3];
          float ci[3];
          bool un[3];
          const int dim[3] = {mx, my, mz};
          int off = 0;
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            const float xi = p[i] / ln[i];
            in_b = in_b && (xi >= 0.0f) && (xi <= 1.0f);
            // clamp in float before the cast: same result as the
            // reference's int clip for every finite value
            float fl = floorf(xi * szf[i]);
            fl = fminf(fmaxf(fl, 0.0f), szf[i] - 1.0f);
            const int si = (int)fl;
            ci[i] = ctr[off + min(si, dim[i] - 1)];
            bool un_i = p[i] >= ci[i];
            if (fl == 0.0f) un_i = true;            // si == 0
            if (fl == szf[i] - 1.0f) un_i = false;  // si == size - 1
            sub[i] = si;
            nbr[i] = max(si + (un_i ? 1 : -1), 0);
            un[i] = un_i;
            off += dim[i];
          }
          if (dirs) {
            dp[t] = (un[0] ? 1 : 0) | (un[1] ? 2 : 0) | (un[2] ? 4 : 0);
            dp += n;
          }
          if (!in_b || tr.w == 0.0f) continue;   // +inf, zero gradient

          // the 4 cells; the index clamp only keeps reads in the slab
          const int last = mxyz - 1;
          const int i0 = (sub[0] * my + sub[1]) * mz + sub[2];
          const float v0 = __ldg(slab + min(i0, last));
          const float vn[3] = {
              __ldg(slab + min((nbr[0] * my + sub[1]) * mz + sub[2], last)),
              __ldg(slab + min((sub[0] * my + nbr[1]) * mz + sub[2], last)),
              __ldg(slab + min(i0 - sub[2] + nbr[2], last))};
          const float amax = fmaxf(fmaxf(fabsf(v0), fabsf(vn[0])),
                                   fmaxf(fabsf(vn[1]), fabsf(vn[2])));
          if (amax == INFINITY) continue;    // a cell not contained: +inf
          float value = v0;
          float g[3];
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            const float dv = vn[i] - v0;
            g[i] = (un[i] ? dv : -dv) * ratio[i];
            value = value + g[i] * (p[i] - ci[i]);
          }
          if (f == 0 || value < best_v) {    // strict: the first field wins ties
            best_v = value;
            win = f;
            g0 = g[0];
            g1 = g[1];
            g2 = g[2];
          }
        }
        // the winner's gradient to world (a zero gradient stays +0)
        float bg[3] = {0.0f, 0.0f, 0.0f};
        if (win >= 0) {
          const float4 q = s_pw[win * kLanes + lane];
          qrot(q.x, q.y, q.z, q.w, g0, g1, g2, bg);
        }

        // -- hinge cost scaled by workspace speed (cost_soa.py:205-232) -----
        const bool has_field = isfinite(best_v);
        const float dist = has_field ? best_v : 0.0f;
        const float d = dist - __ldg(radii + s);
        const float e = e_b;
        const float of = of_b;
        const float v0 = cv0, v1 = cv1, v2 = cv2;
        const float vv = v0 * v0 + v1 * v1 + v2 * v2;
        const float vnorm = sqrtf(vv);
        const float c_in = of * (0.5f * e - d);
        const float dm = d - e;
        const float c_mid = of * half_inv_e * (dm * dm);
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
        const float aproj =
            safe ? (ca0 * v0 + ca1 * v1 + ca2 * v2) / v2s : 0.0f;
        const float inv = safe ? 1.0f / v2s : 0.0f;
        const float kx = (ca0 - v0 * aproj) * inv;
        const float ky = (ca1 - v1 * aproj) * inv;
        const float kz = (ca2 - v2 * aproj) * inv;
        gx = gx - kx * cs;
        gy = gy - ky * cs;
        gz = gz - kz * cs;

        cost[t] = cs;
        wgrad[t] = gx * vnorm;
        wg1[t] = gy * vnorm;
        wg2[t] = gz * vnorm;
      }

      cx0 = nx0, cx1 = nx1, cx2 = nx2;
      s += sstep;
      if (s >= S) s -= S;
    }
  }
}

cudaError_t allow_smem(int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(obstacle_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

}  // namespace

extern "C" int cdx_sdf_cell_lookup(const float* data, int F, int mx, int my,
                                   int mz, const int* sub, const int* nbr,
                                   int Q, float* out, void* stream) {
  long long n = (long long)F * Q;
  if (n == 0) return 0;
  constexpr int kThreads = 256;
  int blocks = (int)((n + kThreads - 1) / kThreads);
  sdf_cell_lookup_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      data, F, mx, my, mz, sub, nbr, Q, out);
  return (int)cudaGetLastError();
}

// The launch geometry (grid, threads, per, smem) comes from
// ops/sdf_lookup.py:launch_geometry; the launch is refused if it does not
// fit the shapes.
extern "C" int cdx_obstacle(const float* x, const float* vel, const float* acc,
                            int m, int S, int B, const float* data, int F,
                            int mx, int my, int mz, const int* sizes,
                            const float* lengths, const float* pose_gw,
                            const float* pose_wg, const unsigned char* enabled,
                            const float* radii, const float* eps,
                            const float* obs_factor, float* cost, float* wgrad,
                            int* dirs, int grid, int threads, int per,
                            int smem, void* stream) {
  const long long rows = (long long)m * S;
  if (rows * B == 0) return 0;
  const long long units = (B + kLanes - 1) / kLanes * rows;
  if (3 * rows * B >= (1LL << 31) || threads % kLanes != 0 ||
      threads < 2 * kLanes || threads > kThreads || per < 1 ||
      (long long)grid * per < units ||
      smem < 4LL * smem_words(F, mx, my, mz))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(smem);
  if (err != cudaSuccess) return (int)err;
  obstacle_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      x, vel, acc, S, B, (int)rows, (int)units, per, data, F, mx, my, mz,
      sizes, lengths, pose_gw, pose_wg, enabled, radii, eps, obs_factor, cost,
      wgrad, dirs);
  return (int)cudaGetLastError();
}

// Bytes of dynamic shared memory the kernel indexes per block.
extern "C" int cdx_obstacle_smem_bytes(int F, int mx, int my, int mz) {
  return 4 * smem_words(F, mx, my, mz);
}

// Launch facts for a block of `threads` threads and `smem` bytes of dynamic
// shared memory: info[0] resident blocks per SM, info[1] registers per
// thread, info[2] local memory per thread (bytes; non-zero means spills).
extern "C" int cdx_obstacle_launch_info(int threads, int smem, int* info) {
  cudaError_t err = allow_smem(smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, obstacle_kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, obstacle_kernel);
  if (err != cudaSuccess) return (int)err;
  info[0] = blocks;
  info[1] = attr.numRegs;
  info[2] = (int)attr.localSizeBytes;
  return 0;
}
