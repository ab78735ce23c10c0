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
//
// float64: both kernels are templates on the scalar type T, and the
// library exports a float64 instantiation of each (the _f64 entry points)
// with the same arithmetic in double.  It keeps two resident blocks per
// SM, not three: double values take twice the registers.  float32 is the
// solve's path; float64 serves modules created with dtype float64.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kLanes = 32;     // problems per warp, and per block tile
constexpr int kThreads = 256;  // threads per block (launch_geometry)
// resident blocks per SM the registers allow: float, double
template <typename T>
constexpr int kMinBlocks = sizeof(T) == 4 ? 3 : 2;

// four values of T in one aligned load: float4, or its double twin
struct __align__(32) Double4 {
  double x, y, z, w;
};
template <typename T>
struct Quad;
template <>
struct Quad<float> {
  using type = float4;
};
template <>
struct Quad<double> {
  using type = Double4;
};

template <typename T>
struct Cells4 {
  T v0, vx, vy, vz;
};

// The float functions for float and the double ones for double, never a
// float promoted to double and rounded back.
__device__ __forceinline__ float mfloor(float v) { return floorf(v); }
__device__ __forceinline__ double mfloor(double v) { return floor(v); }
__device__ __forceinline__ float mfmin(float a, float b) {
  return fminf(a, b);
}
__device__ __forceinline__ double mfmin(double a, double b) {
  return fmin(a, b);
}
__device__ __forceinline__ float mfmax(float a, float b) {
  return fmaxf(a, b);
}
__device__ __forceinline__ double mfmax(double a, double b) {
  return fmax(a, b);
}
__device__ __forceinline__ float mfabs(float v) { return fabsf(v); }
__device__ __forceinline__ double mfabs(double v) { return fabs(v); }
__device__ __forceinline__ float msqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double msqrt(double v) { return sqrt(v); }

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// The 4 cells of one field slab (mx, my, mz): centre (sx, sy, sz) and
// the per-axis neighbours (nx, sy, sz), (sx, ny, sz), (sx, sy, nz).
// Subscripts are clamped to the slab so no read leaves it.
template <typename T>
__device__ __forceinline__ Cells4<T> lookup4(const T* __restrict__ slab,
                                             int mx, int my, int mz, int sx,
                                             int sy, int sz, int nx, int ny,
                                             int nz) {
  sx = clampi(sx, 0, mx - 1);
  sy = clampi(sy, 0, my - 1);
  sz = clampi(sz, 0, mz - 1);
  nx = clampi(nx, 0, mx - 1);
  ny = clampi(ny, 0, my - 1);
  nz = clampi(nz, 0, mz - 1);
  Cells4<T> c;
  c.v0 = __ldg(slab + (sx * my + sy) * mz + sz);
  c.vx = __ldg(slab + (nx * my + sy) * mz + sz);
  c.vy = __ldg(slab + (sx * my + ny) * mz + sz);
  c.vz = __ldg(slab + (sx * my + sy) * mz + nz);
  return c;
}

// v' = v + w*t + q x t with t = 2 (q x v)  (ops/soa.py qrot, same order)
template <typename T>
__device__ __forceinline__ void qrot(T qx, T qy, T qz, T qw, T vx, T vy, T vz,
                                     T* o) {
  T tx = (qy * vz - qz * vy) * T(2);
  T ty = (qz * vx - qx * vz) * T(2);
  T tz = (qx * vy - qy * vx) * T(2);
  o[0] = (vx + tx * qw) + (qy * tz - qz * ty);
  o[1] = (vy + ty * qw) + (qz * tx - qx * tz);
  o[2] = (vz + tz * qw) + (qx * ty - qy * tx);
}

template <typename T>
__global__ void sdf_cell_lookup_kernel(const T* __restrict__ data, int F,
                                       int mx, int my, int mz,
                                       const int* __restrict__ sub,
                                       const int* __restrict__ nbr, int Q,
                                       T* __restrict__ out) {
  long long n = (long long)F * Q;
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  int f = (int)(t / Q);
  const int* s = sub + 3 * t;
  const int* nb = nbr + 3 * t;
  Cells4<T> c = lookup4(data + (long long)f * mx * my * mz, mx, my, mz, s[0],
                     s[1], s[2], nb[0], nb[1], nb[2]);
  out[t] = c.v0;
  out[n + t] = c.vx;
  out[2 * n + t] = c.vy;
  out[3 * n + t] = c.vz;
}

// ---- the obstacle kernel -----------------------------------------------------

// Words of T in a block's shared memory: per field and lane the pose
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
template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks<T>) obstacle_kernel(
    const T* __restrict__ x, const T* __restrict__ vel,
    const T* __restrict__ acc, int S, int B, int rows, int units, int per,
    const T* __restrict__ data, int F, int mx, int my, int mz,
    const int* __restrict__ sizes, const T* __restrict__ lengths,
    const T* __restrict__ pose_gw, const T* __restrict__ pose_wg,
    const unsigned char* __restrict__ enabled, const T* __restrict__ radii,
    const T* __restrict__ eps, const T* __restrict__ obs_factor,
    T* __restrict__ cost, T* __restrict__ wgrad, int* __restrict__ dirs) {
  using T4 = typename Quad<T>::type;
  extern __shared__ __align__(32) unsigned char smem_raw[];
  T4* smem4 = reinterpret_cast<T4*>(smem_raw);
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int lane = tid % kLanes;
  const int warp = tid / kLanes;
  const int W = nthr / kLanes;
  const int n = rows * B;
  const int mxyz = mx * my * mz;
  const int ncell = mx + my + mz;
  T4* s_pg = smem4;                        // [F][2][kLanes]
  T4* s_pw = s_pg + 2 * F * kLanes;        // [F][kLanes]
  T4* s_fc = s_pw + F * kLanes;            // [F][5]
  T* s_ctr = reinterpret_cast<T*>(s_fc + 5 * F);
  T* pg_f = reinterpret_cast<T*>(s_pg);
  T* pw_f = reinterpret_cast<T*>(s_pw);
  T* fc_f = reinterpret_cast<T*>(s_fc);
  const T* x1 = x + n;
  const T* x2 = x1 + n;
  const T* v1p = vel + n;
  const T* v2p = v1p + n;
  const T* a1p = acc + n;
  const T* a2p = a1p + n;
  T* wg1 = wgrad + n;
  T* wg2 = wg1 + n;
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
    T cx0 = 0, cx1 = 0, cx2 = 0;
    if (live && r < r_hi) {
      const int t = r * B + b;
      cx0 = __ldg(x + t), cx1 = __ldg(x1 + t), cx2 = __ldg(x2 + t);
    }
    const T e_b = live ? __ldg(eps + b) : T(1);
    const T of_b = live ? __ldg(obs_factor + b) : T(0);
    const T half_inv_e = T(0.5) / e_b;      // obstacle_ref: 0.5 / eps

    // the staging warps overlap their loads with the constant warp's
    if (!first) __syncthreads();   // the last tile's data is no longer read
    if (tid < nstager) {
      // both poses and field_enabled of this tile, element e = (f * 8 +
      // component) * kLanes + lane (component 7: enabled); up to four
      // elements a thread, their loads issued before the stores
      for (int e0 = tid; e0 < nstage; e0 += 4 * nstager) {
        T vg[4], vw[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int e = e0 + k * nstager;
          const int bl = e % kLanes, fc = e / kLanes;
          const int f = fc / 8, c = fc - 8 * f;
          vg[k] = 0;
          vw[k] = 0;
          if (e < nstage && bl < nb) {
            if (c < 7) {
              const int g = ((b0 + bl) * F + f) * 7 + c;
              vg[k] = __ldg(pose_gw + g);
              vw[k] = __ldg(pose_wg + g);
            } else {
              vg[k] = enabled[(b0 + bl) * F + f] ? T(1) : T(0);
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
        const T szf = (T)sizes[e];
        const T ln = lengths[e];
        const bool pos = ln > T(0) && ln < T(INFINITY);
        fc_f[(5 * f + 0) * 4 + i] = szf;
        fc_f[(5 * f + 1) * 4 + i] = ln;
        fc_f[(5 * f + 2) * 4 + i] = szf / ln;
        // p below lo or above hi makes p / ln < 0 or > 1 for certain
        fc_f[(5 * f + 3) * 4 + i] = pos ? -ln * T(1e-6) : T(-INFINITY);
        fc_f[(5 * f + 4) * 4 + i] = pos ? ln * T(1.0001) : T(INFINITY);
      }
#pragma unroll 4
      for (int e = tc; e < F * ncell; e += kLanes) {
        const int f = e / ncell, c = e - f * ncell;
        const int i = c < mx ? 0 : (c < mx + my ? 1 : 2);
        const int si = c - (i == 0 ? 0 : (i == 1 ? mx : mx + my));
        const T szf = (T)__ldg(sizes + 3 * f + i);
        s_ctr[e] = ((T)si + T(0.5)) / szf * __ldg(lengths + 3 * f + i);
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
      T cv0 = 0, cv1 = 0, cv2 = 0, ca0 = 0, ca1 = 0, ca2 = 0;
      T nx0 = 0, nx1 = 0, nx2 = 0;
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
        T best_v = INFINITY;
        T g0 = 0, g1 = 0, g2 = 0;
        int win = -1;                      // -1: no field contains the query
        const T* ctr = s_ctr;
        const T* slab = data;
        int* dp = dirs;
        for (int f = 0; f < F; ++f, ctr += ncell, slab += mxyz) {
          const T4 q = s_pg[(2 * f) * kLanes + lane];
          const T4 tr = s_pg[(2 * f + 1) * kLanes + lane];
          T p[3];
          qrot(q.x, q.y, q.z, q.w, cx0, cx1, cx2, p);
          p[0] = p[0] + tr.x;
          p[1] = p[1] + tr.y;
          p[2] = p[2] + tr.z;
          const T4* fc = s_fc + 5 * f;
          if (!dirs) {
            // outside the box for certain, or disabled: +inf, no gradient
            const T4 lo = fc[3], hi = fc[4];
            if (tr.w == T(0) || p[0] < lo.x || p[0] > hi.x || p[1] < lo.y ||
                p[1] > hi.y || p[2] < lo.z || p[2] > hi.z)
              continue;
          }
          const T4 szv = fc[0], lnv = fc[1], rtv = fc[2];
          const T szf[3] = {szv.x, szv.y, szv.z};
          const T ln[3] = {lnv.x, lnv.y, lnv.z};
          const T ratio[3] = {rtv.x, rtv.y, rtv.z};
          bool in_b = true;
          int sub[3], nbr[3];
          T ci[3];
          bool un[3];
          const int dim[3] = {mx, my, mz};
          int off = 0;
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            const T xi = p[i] / ln[i];
            in_b = in_b && (xi >= T(0)) && (xi <= T(1));
            // clamp in floating point before the cast: same result as
            // the reference's int clip for every finite value
            T fl = mfloor(xi * szf[i]);
            fl = mfmin(mfmax(fl, T(0)), szf[i] - T(1));
            const int si = (int)fl;
            ci[i] = ctr[off + min(si, dim[i] - 1)];
            bool un_i = p[i] >= ci[i];
            if (fl == T(0)) un_i = true;            // si == 0
            if (fl == szf[i] - T(1)) un_i = false;  // si == size - 1
            sub[i] = si;
            nbr[i] = max(si + (un_i ? 1 : -1), 0);
            un[i] = un_i;
            off += dim[i];
          }
          if (dirs) {
            dp[t] = (un[0] ? 1 : 0) | (un[1] ? 2 : 0) | (un[2] ? 4 : 0);
            dp += n;
          }
          if (!in_b || tr.w == T(0)) continue;   // +inf, zero gradient

          // the 4 cells; the index clamp only keeps reads in the slab
          const int last = mxyz - 1;
          const int i0 = (sub[0] * my + sub[1]) * mz + sub[2];
          const T v0 = __ldg(slab + min(i0, last));
          const T vn[3] = {
              __ldg(slab + min((nbr[0] * my + sub[1]) * mz + sub[2], last)),
              __ldg(slab + min((sub[0] * my + nbr[1]) * mz + sub[2], last)),
              __ldg(slab + min(i0 - sub[2] + nbr[2], last))};
          const T amax = mfmax(mfmax(mfabs(v0), mfabs(vn[0])),
                               mfmax(mfabs(vn[1]), mfabs(vn[2])));
          if (amax == T(INFINITY)) continue;  // a cell not contained: +inf
          T value = v0;
          T g[3];
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            const T dv = vn[i] - v0;
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
        T bg[3] = {0, 0, 0};
        if (win >= 0) {
          const T4 q = s_pw[win * kLanes + lane];
          qrot(q.x, q.y, q.z, q.w, g0, g1, g2, bg);
        }

        // -- hinge cost scaled by workspace speed (cost_soa.py:205-232) -----
        const bool has_field = isfinite(best_v);
        const T dist = has_field ? best_v : T(0);
        const T d = dist - __ldg(radii + s);
        const T e = e_b;
        const T of = of_b;
        const T v0 = cv0, v1 = cv1, v2 = cv2;
        const T vv = v0 * v0 + v1 * v1 + v2 * v2;
        const T vnorm = msqrt(vv);
        const T c_in = of * (T(0.5) * e - d);
        const T dm = d - e;
        const T c_mid = of * half_inv_e * (dm * dm);
        T cs = vnorm * (d < T(0) ? c_in : (d < e ? c_mid : T(0)));
        cs = has_field ? cs : T(0);
        const T slope = d < T(0) ? T(-1) : (d < e ? d / e - T(1) : T(0));
        const T sc = has_field ? slope * vnorm * of : T(0);
        T gx = bg[0] * sc, gy = bg[1] * sc, gz = bg[2] * sc;

        // projection off the velocity + curvature (orcdchomp_mod.cpp:1225-1241)
        const bool safe = vnorm > T(1e-6);
        const T v2s = safe ? vv : T(1);
        const T proj = safe ? (gx * v0 + gy * v1 + gz * v2) / v2s : T(0);
        gx = gx - v0 * proj;
        gy = gy - v1 * proj;
        gz = gz - v2 * proj;
        const T aproj = safe ? (ca0 * v0 + ca1 * v1 + ca2 * v2) / v2s : T(0);
        const T inv = safe ? T(1) / v2s : T(0);
        const T kx = (ca0 - v0 * aproj) * inv;
        const T ky = (ca1 - v1 * aproj) * inv;
        const T kz = (ca2 - v2 * aproj) * inv;
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

template <typename T>
cudaError_t allow_smem(int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(obstacle_kernel<T>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

template <typename T>
int cell_lookup(const T* data, int F, int mx, int my, int mz, const int* sub,
                const int* nbr, int Q, T* out, void* stream) {
  long long n = (long long)F * Q;
  if (n == 0) return 0;
  constexpr int kThreads = 256;
  int blocks = (int)((n + kThreads - 1) / kThreads);
  sdf_cell_lookup_kernel<T><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      data, F, mx, my, mz, sub, nbr, Q, out);
  return (int)cudaGetLastError();
}

// The launch geometry (grid, threads, per, smem) comes from
// ops/sdf_lookup.py:launch_geometry; the launch is refused if it does not
// fit the shapes.
template <typename T>
int obstacle(const T* x, const T* vel, const T* acc, int m, int S, int B,
             const T* data, int F, int mx, int my, int mz, const int* sizes,
             const T* lengths, const T* pose_gw, const T* pose_wg,
             const unsigned char* enabled, const T* radii, const T* eps,
             const T* obs_factor, T* cost, T* wgrad, int* dirs, int grid,
             int threads, int per, int smem, void* stream) {
  const long long rows = (long long)m * S;
  if (rows * B == 0) return 0;
  const long long units = (B + kLanes - 1) / kLanes * rows;
  if (3 * rows * B >= (1LL << 31) || threads % kLanes != 0 ||
      threads < 2 * kLanes || threads > kThreads || per < 1 ||
      (long long)grid * per < units ||
      smem < (long long)sizeof(T) * smem_words(F, mx, my, mz))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem<T>(smem);
  if (err != cudaSuccess) return (int)err;
  obstacle_kernel<T><<<grid, threads, smem, (cudaStream_t)stream>>>(
      x, vel, acc, S, B, (int)rows, (int)units, per, data, F, mx, my, mz,
      sizes, lengths, pose_gw, pose_wg, enabled, radii, eps, obs_factor, cost,
      wgrad, dirs);
  return (int)cudaGetLastError();
}

// Launch facts for a block of `threads` threads and `smem` bytes of dynamic
// shared memory: info[0] resident blocks per SM, info[1] registers per
// thread, info[2] local memory per thread (bytes; non-zero means spills).
template <typename T>
int launch_info(int threads, int smem, int* info) {
  cudaError_t err = allow_smem<T>(smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, obstacle_kernel<T>, threads, smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, obstacle_kernel<T>);
  if (err != cudaSuccess) return (int)err;
  info[0] = blocks;
  info[1] = attr.numRegs;
  info[2] = (int)attr.localSizeBytes;
  return 0;
}

}  // namespace

// The entry points: float32, and its float64 twin (suffix _f64) with the
// same arguments in double.
extern "C" int cdx_sdf_cell_lookup(const float* data, int F, int mx, int my,
                                   int mz, const int* sub, const int* nbr,
                                   int Q, float* out, void* stream) {
  return cell_lookup(data, F, mx, my, mz, sub, nbr, Q, out, stream);
}

extern "C" int cdx_sdf_cell_lookup_f64(const double* data, int F, int mx,
                                       int my, int mz, const int* sub,
                                       const int* nbr, int Q, double* out,
                                       void* stream) {
  return cell_lookup(data, F, mx, my, mz, sub, nbr, Q, out, stream);
}

extern "C" int cdx_obstacle(const float* x, const float* vel, const float* acc,
                            int m, int S, int B, const float* data, int F,
                            int mx, int my, int mz, const int* sizes,
                            const float* lengths, const float* pose_gw,
                            const float* pose_wg, const unsigned char* enabled,
                            const float* radii, const float* eps,
                            const float* obs_factor, float* cost, float* wgrad,
                            int* dirs, int grid, int threads, int per,
                            int smem, void* stream) {
  return obstacle(x, vel, acc, m, S, B, data, F, mx, my, mz, sizes, lengths,
                  pose_gw, pose_wg, enabled, radii, eps, obs_factor, cost,
                  wgrad, dirs, grid, threads, per, smem, stream);
}

extern "C" int cdx_obstacle_f64(
    const double* x, const double* vel, const double* acc, int m, int S,
    int B, const double* data, int F, int mx, int my, int mz,
    const int* sizes, const double* lengths, const double* pose_gw,
    const double* pose_wg, const unsigned char* enabled, const double* radii,
    const double* eps, const double* obs_factor, double* cost, double* wgrad,
    int* dirs, int grid, int threads, int per, int smem, void* stream) {
  return obstacle(x, vel, acc, m, S, B, data, F, mx, my, mz, sizes, lengths,
                  pose_gw, pose_wg, enabled, radii, eps, obs_factor, cost,
                  wgrad, dirs, grid, threads, per, smem, stream);
}

// Bytes of dynamic shared memory the kernel indexes per block.
extern "C" int cdx_obstacle_smem_bytes(int F, int mx, int my, int mz) {
  return (int)sizeof(float) * smem_words(F, mx, my, mz);
}

extern "C" int cdx_obstacle_smem_bytes_f64(int F, int mx, int my, int mz) {
  return (int)sizeof(double) * smem_words(F, mx, my, mz);
}

extern "C" int cdx_obstacle_launch_info(int threads, int smem, int* info) {
  return launch_info<float>(threads, smem, info);
}

extern "C" int cdx_obstacle_launch_info_f64(int threads, int smem,
                                            int* info) {
  return launch_info<double>(threads, smem, info);
}
