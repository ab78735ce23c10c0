// K2: all-pairs sphere self-collision cost and net workspace gradient.
//
// Replaces the Pallas TPU kernel or_cdchomp_tpu/ops/pallas_selfcol.py
// (_make_kernel / _selfcol_call / selfcol_pairs), whose values the main
// path computed through the dense XLA form
// or_cdchomp_tpu/chomp/cost_soa.py:_selfcol_soa.  Per ordered pair
// (i active, j any sphere, not on the same link):
//
//   w1 = slope * obs_self * |v_i| / d
//   w2 = [|v_i| > 1e-6] * w1 * (v_i . (x_i - x_j)) / |v_i|^2
//   net_i += w1 (x_i - x_j) - w2 v_i,   net_j -= the same (j active)
//   cost_i += [d <= eps] * hinge(d) * obs_self * |v_i|
//
// What bounds it on the H100: memory.  At the flagship shape (m=99 moving
// points, Sa=15 active and SI=1 inactive spheres, B=256 problems, P=207
// pairs) the call must read xi and vel and write net (4.56 MB each) and
// cost (1.52 MB): 15.21 MB, 4.54 us at 3.35 TB/s.  The arithmetic it needs,
// every pair's distance test and the rest of the math for the ~16% of
// (point, pair, problem) in reach, is ~0.1 GFLOP, ~1.4 us at the fp32 peak.
//
// What held the first design back (0.109 ms, 4% of the bound): one thread
// per (point, problem), 25,344 threads (4-8 warps per SM), each walking all
// 207 pairs in sequence with 4-7 shared-memory read-modify-writes per pair,
// no pair skipping, and no fused multiply-adds.
//
// What this design does about it:
//  - One thread per (point k, active sphere i, problem b), the problem
//    fastest: a warp is 32 problems at one (k, i), 380,160 threads at the
//    flagship shape.  A block is one point k and 32 problems, one warp per
//    active sphere, three blocks resident per SM.
//  - Each thread owns net[:, k, i, b] and cost[k, i, b] in registers.  It
//    sums its outgoing pairs (i, j) (+g, and the pair cost), then its
//    incoming pairs (j', i) with j' active (-g, recomputed with v_j'), each
//    in pair order, as the plain version adds them.  No accumulator lives in
//    shared memory, nothing is read-modified-written, no atomics: every
//    output is written once, coalesced, and two runs are bit-equal.
//  - The block stages the positions of all Sa + SI spheres and the
//    velocities, |v| and 1/|v|^2 of the active ones for its 32 problems in
//    shared memory once (coalesced loads), with each sphere's bounding box
//    over the 32 problems, and turns the pair table into a dense (Sa, So)
//    matrix there.  A warp reads row i (outgoing) and column i (incoming)
//    of the matrix, one lane per sphere, into 32-bit masks: it steps only
//    through the pairs that exist, never through the whole pair list.
//  - Two tests skip pairs out of reach, both exact.  One lane-parallel pass
//    over the row compares the boxes of spheres i and j: a pair whose gap
//    exceeds rsum + the warp's largest eps (with a margin far above either
//    test's rounding) is out of reach in all 32 problems.  The pairs left
//    run the distance part (diff, d^2, rsqrt, d), and the rest of the pair
//    math only if __any_sync says some problem is within eps.  A pair with
//    d > eps adds exactly 0 to cost and gradient (w1 = 0), so no bit of any
//    sum changes: this is the Pallas kernel's pl.when skip, decided per
//    warp.  An incoming pair (j', i) whose mirror (i, j') exists with the
//    same rsum has a bit-equal d, so it takes the outgoing vote.
//  - Fused multiply-adds are written out with __fmaf_rn (the library is
//    built with -fmad=false for K1's sake); 1/|v|^2 and 1/eps use the
//    correctly rounded reciprocal, rsqrt the bare MUFU instruction.
//
// What bounds the design now is instruction throughput: the ~600
// instructions a warp runs (votes, shuffles, shared-memory loads), not
// bytes; PERF.md has its time against the bound.
//
// That staged path's shared memory grows as Sa*So (the pair matrices) and
// 262*S words of per-sphere terms: from Sa = So = 118 spheres (a robot
// holding a body modelled by ~100 spheres) a block needs more than the
// 227 KB an H100 block may have.  So a launch takes one of two paths, by a
// fixed rule (selfcol_path_staged; ops/selfcol.py launch_shape mirrors it):
//
//  - staged (above), wherever its block fits in 232,448 B;
//  - tiled, beyond: no shared memory at all.  A setup kernel turns the pair
//    table into the dense (Sa, So) matrices of pair indices and radius
//    sums in a global scratch buffer (after a memset of the indices to
//    -1), and writes each sphere's bounding box over each 32-problem tile
//    at each point there too.  The main kernel keeps one thread per
//    (point, active sphere, problem), one warp per sphere (8 per block),
//    and walks the other spheres 32 at a time: lane l reads row i and
//    column i of the matrices and sphere base+l's box through L1, the
//    same box test and warp votes skip pairs out of reach exactly, and the
//    positions and velocities of the pairs taken are read from global
//    memory (the block's warps share one point and one tile, so they hit
//    in L1).  Outgoing and incoming pairs of a 32-sphere chunk are handled
//    together, into two register sums added at the end: no atomics, the
//    same order on every launch, so it is bit-deterministic too.
//
// The arithmetic is the Pallas body's: difference form |x_i - x_j|^2 (not
// the expanded form, which cancels in f32), rsqrt(max(d2, 1e-24)) for both
// 1/d and d, the |v| > 1e-6 guard, and the hinge of pallas_selfcol.py.
//
// float64: the tiled path's kernels are templates on the scalar type T,
// and the library exports a float64 entry point (cdx_selfcol_f64) that
// always takes the tiled path, with the same pair math in double (1/sqrt
// from the double rsqrt, not the float MUFU instruction).  The staged
// path stays float32: its block keeps three resident blocks of up to 16
// warps per SM, 40 registers a thread, which double values would spill.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kLanes = 32;      // problems per warp and per block
constexpr int kMaxWarps = 16;   // warps per block: active spheres in flight
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMinBlocks = 3;   // resident blocks per SM: <= 40 registers
constexpr size_t kSmemBlockMax = 232448;   // shared memory a block may use
constexpr int kTiledWarps = 8;  // warps (active spheres) per tiled block

template <typename T>
struct V3 {
  T x, y, z;
};
using Vec3 = V3<float>;

// The float intrinsics for float and the double ones for double.
__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}
__device__ __forceinline__ float rcp_rn(float v) { return __frcp_rn(v); }
__device__ __forceinline__ double rcp_rn(double v) { return __drcp_rn(v); }
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
__device__ __forceinline__ float msqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double msqrt(double v) { return sqrt(v); }

// 1/sqrt(x) in one MUFU instruction.  x >= 1e-24 is a normal float, so
// flushing denormals changes nothing; it only drops the denormal fixup
// code that rsqrtf carries without -ftz.
__device__ __forceinline__ float rsqrt_ftz(float x) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ double rsqrt_ftz(double x) { return rsqrt(x); }

// The distance part of pair (a, b): diff = a - b and the rsqrt of |diff|^2.
template <typename T>
struct PairDist {
  V3<T> diff;
  T inv_cd;   // 1 / max(|diff|, 1e-12)
  T d;        // |diff| - rsum
};
using Dist = PairDist<float>;

template <typename T>
__device__ __forceinline__ PairDist<T> distance(V3<T> a, V3<T> b, T rs) {
  PairDist<T> r;
  r.diff = {a.x - b.x, a.y - b.y, a.z - b.z};
  const T dd = fma_rn(r.diff.z, r.diff.z,
                      fma_rn(r.diff.y, r.diff.y, r.diff.x * r.diff.x));
  r.inv_cd = rsqrt_ftz(mfmax(dd, T(1e-24)));
  r.d = dd * r.inv_cd - rs;
  return r;
}

// The rest of the pair math for the sphere that owns velocity v:
// the gradient g (net_a += g, net_b -= g) and the pair cost.
template <typename T>
__device__ __forceinline__ T pair_grad(const PairDist<T>& p, V3<T> v, T ofv,
                                       T iv2, bool safe, T e, T inv_e,
                                       V3<T>* g) {
  const bool ok = p.d <= e;
  const T de = p.d - e;
  const T c_h = p.d < T(0) ? T(0.5) * e - p.d : T(0.5) * de * de * inv_e;
  const T slope = p.d < T(0) ? T(-1) : fma_rn(p.d, inv_e, T(-1));
  const T w1 = ok ? slope * ofv * p.inv_cd : T(0);
  const T bv = fma_rn(v.z, p.diff.z, fma_rn(v.y, p.diff.y, v.x * p.diff.x));
  const T w2 = safe ? w1 * bv * iv2 : T(0);
  g->x = fma_rn(w1, p.diff.x, -(w2 * v.x));
  g->y = fma_rn(w1, p.diff.y, -(w2 * v.y));
  g->z = fma_rn(w1, p.diff.z, -(w2 * v.z));
  return (ok ? c_h : T(0)) * ofv;
}

// Shared memory of one block of nw warps, in 4-byte words: positions
// [3][So][32], velocities [3][Sa][32], |v| [Sa][32], 1/|v|^2 [Sa][32], the
// bounding box of each sphere over the block's problems [6][So] (low
// corner, high corner), the (Sa, So) matrices of radius sums and pair
// indices, then per warp one word per 32 spheres (the votes its incoming
// walk takes over).
__host__ __device__ inline size_t smem_words(int Sa, int So, int nw) {
  return (size_t)kLanes * (3 * So + 5 * Sa) + 6 * (size_t)So +
         2 * (size_t)Sa * So + (size_t)nw * ((So + kLanes - 1) / kLanes);
}

// Component c of sphere s's bounding box: the warp-wide min and max of v
// over the live lanes, written to sbox by lane 0.
template <typename T>
__device__ __forceinline__ void stage_box(T* sbox, int So, int s, int c, T v,
                                          bool live, int lane) {
  T lo = live ? v : T(INFINITY);
  T hi = live ? v : T(-INFINITY);
  for (int off = kLanes / 2; off > 0; off /= 2) {
    lo = mfmin(lo, __shfl_xor_sync(kFull, lo, off));
    hi = mfmax(hi, __shfl_xor_sync(kFull, hi, off));
  }
  if (lane == 0) {
    sbox[c * So + s] = lo;
    sbox[(3 + c) * So + s] = hi;
  }
}

// Warp-wide max of v over the live lanes.
template <typename T>
__device__ __forceinline__ T warp_max(T v, bool live) {
  T z = live ? v : T(-INFINITY);
  for (int off = kLanes / 2; off > 0; off /= 2)
    z = mfmax(z, __shfl_xor_sync(kFull, z, off));
  return z;
}

// Can any problem of the warp have pair (a, b) within reach?  The gap
// between the two spheres' boxes is no more than any problem's distance,
// so a pair whose gap exceeds rsum + the warp's largest eps, with a margin
// far above the rounding of either test, has d > eps in every problem.
__device__ __forceinline__ bool boxes_near(const float* sbox, int So, int a,
                                           int b, float rs, float emax) {
  float g2 = 0.f;
  for (int c = 0; c < 3; ++c) {
    const float lo_a = sbox[c * So + a], hi_a = sbox[(3 + c) * So + a];
    const float lo_b = sbox[c * So + b], hi_b = sbox[(3 + c) * So + b];
    const float gap = fmaxf(0.f, fmaxf(lo_b - hi_a, lo_a - hi_b));
    g2 = __fmaf_rn(gap, gap, g2);
  }
  const float reach = (emax + rs) * (1.0f + 1e-4f) + 1e-6f;
  return g2 <= reach * reach;
}

__device__ __forceinline__ Vec3 load3(const float* s, int rows, int r,
                                      int lane) {
  return {s[(0 * rows + r) * kLanes + lane], s[(1 * rows + r) * kLanes + lane],
          s[(2 * rows + r) * kLanes + lane]};
}

__global__ void __launch_bounds__(kMaxWarps * kLanes, kMinBlocks)
selfcol_kernel(const float* __restrict__ xi, const float* __restrict__ vel,
               const float* __restrict__ xo, int m, int Sa, int SI, int B,
               const int* __restrict__ pair_i, const int* __restrict__ pair_j,
               const float* __restrict__ rsum, int P,
               const float* __restrict__ eps_self,
               const float* __restrict__ obs_self, float* __restrict__ net,
               float* __restrict__ cost) {
  extern __shared__ float smem[];
  const int So = Sa + SI;
  const int lane = threadIdx.x;
  const int w = threadIdx.y;
  const int nw = blockDim.y;
  float* sx = smem;                              // [3][So][32]
  float* sv = sx + 3 * So * kLanes;              // [3][Sa][32]
  float* svn = sv + 3 * Sa * kLanes;             // [Sa][32]
  float* siv2 = svn + Sa * kLanes;               // [Sa][32]
  float* sbox = siv2 + Sa * kLanes;              // [6][So]
  float* srs = sbox + 6 * So;                    // [Sa][So]
  int* sidx = reinterpret_cast<int*>(srs + Sa * So);   // [Sa][So], -1: none

  const int tid = w * kLanes + lane;
  const int nt = nw * kLanes;
  const int k = blockIdx.y;
  const int b = blockIdx.x * kLanes + lane;
  const bool live = b < B;          // dead lanes vote "out of reach"
  const long long n = (long long)m * Sa * B;   // component stride of xi
  const long long no = (long long)SI * B;      // component stride of xo

  for (int q = tid; q < Sa * So; q += nt) sidx[q] = -1;
  for (int s = w; s < Sa; s += nw) {
    float x0 = 0.f, x1 = 0.f, x2 = 0.f, v0 = 0.f, v1 = 0.f, v2 = 0.f;
    if (live) {
      const long long at = ((long long)k * Sa + s) * B + b;
      x0 = xi[at];
      x1 = xi[n + at];
      x2 = xi[2 * n + at];
      v0 = vel[at];
      v1 = vel[n + at];
      v2 = vel[2 * n + at];
    }
    sx[(0 * So + s) * kLanes + lane] = x0;
    sx[(1 * So + s) * kLanes + lane] = x1;
    sx[(2 * So + s) * kLanes + lane] = x2;
    sv[(0 * Sa + s) * kLanes + lane] = v0;
    sv[(1 * Sa + s) * kLanes + lane] = v1;
    sv[(2 * Sa + s) * kLanes + lane] = v2;
    stage_box(sbox, So, s, 0, x0, live, lane);
    stage_box(sbox, So, s, 1, x1, live, lane);
    stage_box(sbox, So, s, 2, x2, live, lane);
    const float vv = __fmaf_rn(v2, v2, __fmaf_rn(v1, v1, v0 * v0));
    const float vn = sqrtf(vv);
    svn[s * kLanes + lane] = vn;
    siv2[s * kLanes + lane] = vn > 1e-6f ? __frcp_rn(vv) : 0.0f;
  }
  for (int s = w; s < SI; s += nw) {
    const long long at = (long long)s * B + b;
    for (int c = 0; c < 3; ++c) {
      const float v = live ? xo[c * no + at] : 0.f;
      sx[(c * So + Sa + s) * kLanes + lane] = v;
      stage_box(sbox, So, Sa + s, c, v, live, lane);
    }
  }
  __syncthreads();
  for (int p = tid; p < P; p += nt) {
    const int i = pair_i[p];
    const int j = pair_j[p];
    if (i >= 0 && i < Sa && j >= 0 && j < So) {
      sidx[i * So + j] = p;
      srs[i * So + j] = rsum[p];
    }
  }
  __syncthreads();

  const float e = live ? eps_self[b] : 1.0f;
  const float inv_e = __frcp_rn(e);
  const float ofs = live ? obs_self[b] : 0.0f;
  const float emax = warp_max(e, live);   // the largest eps of the warp

  const int nch = (So + kLanes - 1) / kLanes;   // 32-sphere chunks
  unsigned* wvotes = reinterpret_cast<unsigned*>(sidx + Sa * So) + w * nch;

  for (int i = w; i < Sa; i += nw) {
    const Vec3 xs = load3(sx, So, i, lane);
    const Vec3 vs = load3(sv, Sa, i, lane);
    const float vn = svn[i * kLanes + lane];
    const float ofv = ofs * vn;
    const float iv2 = siv2[i * kLanes + lane];
    const bool safe = vn > 1e-6f;
    Vec3 acc = {0.f, 0.f, 0.f};
    float c_acc = 0.f;

    // Outgoing pairs (i, j), j ascending: net_i += g, cost_i += the pair
    // cost, 32 spheres j at a time.
    for (int ch = 0; ch < nch; ++ch) {
      const int base = ch * kLanes;
      const int j = base + lane;
      const bool out = j < So && sidx[i * So + j] >= 0;
      // pair (j, i) exists with the same radius sum: its d is bit-equal
      // to that of (i, j), so the incoming walk takes this vote over
      const bool mirror = out && j < Sa && sidx[j * So + i] >= 0 &&
                          srs[j * So + i] == srs[i * So + j];
      const unsigned mirrors = __ballot_sync(kFull, mirror);
      const bool near = out && boxes_near(sbox, So, i, j, srs[i * So + j],
                                          emax);
      unsigned taken = 0u;
      for (unsigned bits = __ballot_sync(kFull, near); bits;
           bits &= bits - 1u) {
        const int c = __ffs(bits) - 1;
        const Dist p = distance(xs, load3(sx, So, base + c, lane),
                                srs[i * So + base + c]);
        if (!__any_sync(kFull, live && p.d <= e)) continue;
        taken |= 1u << c;
        Vec3 g;
        c_acc += pair_grad(p, vs, ofv, iv2, safe, e, inv_e, &g);
        acc.x += g.x;
        acc.y += g.y;
        acc.z += g.z;
      }
      if (lane == 0) wvotes[ch] = taken & mirrors;
    }
    __syncwarp();
    // Incoming pairs (j', i), j' active and ascending: net_i -= g(j', i),
    // with j''s velocity.  Only the pairs without a mirror vote here; then
    // the pair math for the votes taken.
    for (int ch = 0; ch < nch; ++ch) {
      const int base = ch * kLanes;
      const int j = base + lane;
      const bool in = j < Sa && sidx[j * So + i] >= 0;
      const bool mirror = in && sidx[i * So + j] >= 0 &&
                          srs[j * So + i] == srs[i * So + j];
      const bool near = in && !mirror &&
                        boxes_near(sbox, So, j, i, srs[j * So + i], emax);
      unsigned taken = wvotes[ch];
      for (unsigned bits = __ballot_sync(kFull, near); bits;
           bits &= bits - 1u) {
        const int c = __ffs(bits) - 1;
        const Dist p = distance(load3(sx, So, base + c, lane), xs,
                                srs[(base + c) * So + i]);
        taken |= (unsigned)(__any_sync(kFull, live && p.d <= e) != 0) << c;
      }
      for (; taken; taken &= taken - 1u) {
        const int jj = base + __ffs(taken) - 1;
        const Dist p = distance(load3(sx, So, jj, lane), xs,
                                srs[jj * So + i]);
        const float vnj = svn[jj * kLanes + lane];
        Vec3 g;
        pair_grad(p, load3(sv, Sa, jj, lane), ofs * vnj,
                  siv2[jj * kLanes + lane], vnj > 1e-6f, e, inv_e, &g);
        acc.x -= g.x;
        acc.y -= g.y;
        acc.z -= g.z;
      }
    }
    __syncwarp();

    if (live) {
      const long long at = ((long long)k * Sa + i) * B + b;
      net[at] = acc.x;
      net[n + at] = acc.y;
      net[2 * n + at] = acc.z;
      cost[at] = c_acc;
    }
  }
}

// Component c of sphere s's position at (point k, problem b): an active
// sphere from xi, an inactive one from xo.
template <typename T>
__device__ __forceinline__ T pos_at(const T* __restrict__ xi,
                                    const T* __restrict__ xo, int c,
                                    long long n, long long no, int Sa, int k,
                                    int s, int B, int b) {
  return s < Sa ? __ldg(xi + c * n + ((long long)k * Sa + s) * B + b)
                : __ldg(xo + c * no + (long long)(s - Sa) * B + b);
}

template <typename T>
__device__ __forceinline__ V3<T> pos3(const T* __restrict__ xi,
                                      const T* __restrict__ xo, long long n,
                                      long long no, int Sa, int k, int s,
                                      int B, int b) {
  return {pos_at(xi, xo, 0, n, no, Sa, k, s, B, b),
          pos_at(xi, xo, 1, n, no, Sa, k, s, B, b),
          pos_at(xi, xo, 2, n, no, Sa, k, s, B, b)};
}

// Setup of the tiled path, grid (tiles, m), blocks of 32 x nw threads:
// every thread scatters its share of the pair table into the dense (Sa,
// So) matrices pidx (indices, set to -1 before) and prs (radius sums), and
// the block writes the bounding box of every sphere over its tile's
// problems at its point to box[k][tile][6][So] (low corner, high corner).
template <typename T>
__global__ void selfcol_prep_kernel(
    const T* __restrict__ xi, const T* __restrict__ xo, int m, int Sa, int SI,
    int B, const int* __restrict__ pair_i, const int* __restrict__ pair_j,
    const T* __restrict__ rsum, int P, int* __restrict__ pidx,
    T* __restrict__ prs, T* __restrict__ box) {
  const int So = Sa + SI;
  const int lane = threadIdx.x;
  const int nw = blockDim.y;
  const long long nt = (long long)gridDim.x * gridDim.y * nw * kLanes;
  const long long tid =
      (((long long)blockIdx.y * gridDim.x + blockIdx.x) * nw + threadIdx.y) *
          kLanes + lane;
  for (long long p = tid; p < P; p += nt) {
    const int i = pair_i[p];
    const int j = pair_j[p];
    if (i >= 0 && i < Sa && j >= 0 && j < So) {
      pidx[(long long)i * So + j] = (int)p;
      prs[(long long)i * So + j] = rsum[p];
    }
  }
  const int k = blockIdx.y;
  const int b = blockIdx.x * kLanes + lane;
  const bool live = b < B;
  const long long n = (long long)m * Sa * B;
  const long long no = (long long)SI * B;
  T* bx = box + ((long long)k * gridDim.x + blockIdx.x) * 6 * So;
  for (int s = threadIdx.y; s < So; s += nw)
    for (int c = 0; c < 3; ++c)
      stage_box(bx, So, s, c,
                live ? pos_at(xi, xo, c, n, no, Sa, k, s, B, b) : T(0), live,
                lane);
}

// The tiled path's main kernel, grid (tiles, m, ceil(Sa / 8)), blocks of
// 32 x 8 threads: thread (lane, w) owns (point k, active sphere i =
// 8*blockIdx.z + w, problem b = 32*tile + lane).  Same pair math, skip tests
// and contract as selfcol_kernel.
template <typename T>
__global__ void __launch_bounds__(kTiledWarps * kLanes)
selfcol_tiled_kernel(const T* __restrict__ xi, const T* __restrict__ vel,
                     const T* __restrict__ xo, int m, int Sa, int SI, int B,
                     const int* __restrict__ pidx, const T* __restrict__ prs,
                     const T* __restrict__ box,
                     const T* __restrict__ eps_self,
                     const T* __restrict__ obs_self, T* __restrict__ net,
                     T* __restrict__ cost) {
  const int So = Sa + SI;
  const int lane = threadIdx.x;
  const int i = blockIdx.z * blockDim.y + threadIdx.y;
  if (i >= Sa) return;              // a whole warp: no block barrier follows
  const int k = blockIdx.y;
  const int b = blockIdx.x * kLanes + lane;
  const bool live = b < B;          // dead lanes vote "out of reach"
  const long long n = (long long)m * Sa * B;
  const long long no = (long long)SI * B;
  const long long at = ((long long)k * Sa + i) * B + b;

  V3<T> xs = {0, 0, 0}, vs = {0, 0, 0};
  if (live) {
    xs = {__ldg(xi + at), __ldg(xi + n + at), __ldg(xi + 2 * n + at)};
    vs = {__ldg(vel + at), __ldg(vel + n + at), __ldg(vel + 2 * n + at)};
  }
  const T vv = fma_rn(vs.z, vs.z, fma_rn(vs.y, vs.y, vs.x * vs.x));
  const T vn = msqrt(vv);
  const bool safe = vn > T(1e-6);
  const T iv2 = safe ? rcp_rn(vv) : T(0);
  const T e = live ? eps_self[b] : T(1);
  const T inv_e = rcp_rn(e);
  const T ofs = live ? obs_self[b] : T(0);
  const T ofv = ofs * vn;
  const T emax = warp_max(e, live);   // the largest eps of the warp

  const T* bx = box + ((long long)k * gridDim.x + blockIdx.x) * 6 * So;
  T lo_i[3], hi_i[3];
  for (int c = 0; c < 3; ++c) {
    lo_i[c] = __ldg(bx + c * So + i);
    hi_i[c] = __ldg(bx + (3 + c) * So + i);
  }
  const int* prow = pidx + (long long)i * So;
  const T* rrow = prs + (long long)i * So;

  V3<T> acc_out = {0, 0, 0}, acc_in = {0, 0, 0};
  T c_acc = 0;
  for (int base = 0; base < So; base += kLanes) {
    const int j = base + lane;
    // pair (i, j) outgoing, pair (j, i) incoming with j active; a mirror
    // (both, same radius sum) has a bit-equal d, so one vote serves both
    const bool out = j < So && __ldg(prow + j) >= 0;
    const T rs_out = out ? __ldg(rrow + j) : T(0);
    const long long ji = (long long)j * So + i;
    const bool in = j < Sa && __ldg(pidx + ji) >= 0;
    const T rs_in = in ? __ldg(prs + ji) : T(0);
    const bool mirror = out && in && rs_in == rs_out;
    const unsigned mirrors = __ballot_sync(kFull, mirror);
    bool near_out = false, near_in = false;
    if (out || (in && !mirror)) {
      // boxes_near on the global boxes: the gap is symmetric in (i, j)
      T g2 = 0;
      for (int c = 0; c < 3; ++c) {
        const T lo_j = __ldg(bx + c * So + j);
        const T hi_j = __ldg(bx + (3 + c) * So + j);
        const T gap = mfmax(T(0), mfmax(lo_j - hi_i[c], lo_i[c] - hi_j));
        g2 = fma_rn(gap, gap, g2);
      }
      const T r_out = (emax + rs_out) * (T(1) + T(1e-4)) + T(1e-6);
      const T r_in = (emax + rs_in) * (T(1) + T(1e-4)) + T(1e-6);
      near_out = out && g2 <= r_out * r_out;
      near_in = in && !mirror && g2 <= r_in * r_in;
    }

    unsigned taken = 0u;
    for (unsigned bits = __ballot_sync(kFull, near_out); bits;
         bits &= bits - 1u) {
      const int c = __ffs(bits) - 1;
      const T rs = __shfl_sync(kFull, rs_out, c);
      const V3<T> xj = live ? pos3(xi, xo, n, no, Sa, k, base + c, B, b)
                            : V3<T>{0, 0, 0};
      const PairDist<T> p = distance(xs, xj, rs);
      if (!__any_sync(kFull, live && p.d <= e)) continue;
      taken |= 1u << c;
      V3<T> g;
      c_acc += pair_grad(p, vs, ofv, iv2, safe, e, inv_e, &g);
      acc_out.x += g.x;
      acc_out.y += g.y;
      acc_out.z += g.z;
    }
    taken &= mirrors;
    for (unsigned bits = __ballot_sync(kFull, near_in); bits;
         bits &= bits - 1u) {
      const int c = __ffs(bits) - 1;
      const T rs = __shfl_sync(kFull, rs_in, c);
      const V3<T> xj = live ? pos3(xi, xo, n, no, Sa, k, base + c, B, b)
                            : V3<T>{0, 0, 0};
      const PairDist<T> p = distance(xj, xs, rs);
      taken |= (unsigned)(__any_sync(kFull, live && p.d <= e) != 0) << c;
    }
    for (; taken; taken &= taken - 1u) {
      const int c = __ffs(taken) - 1;
      const int jj = base + c;
      const T rs = __shfl_sync(kFull, rs_in, c);
      V3<T> xj = {0, 0, 0}, vj = {0, 0, 0};
      if (live) {
        const long long aj = ((long long)k * Sa + jj) * B + b;
        xj = {__ldg(xi + aj), __ldg(xi + n + aj), __ldg(xi + 2 * n + aj)};
        vj = {__ldg(vel + aj), __ldg(vel + n + aj), __ldg(vel + 2 * n + aj)};
      }
      const T vvj = fma_rn(vj.z, vj.z, fma_rn(vj.y, vj.y, vj.x * vj.x));
      const T vnj = msqrt(vvj);
      const bool safej = vnj > T(1e-6);
      const PairDist<T> p = distance(xj, xs, rs);
      V3<T> g;
      pair_grad(p, vj, ofs * vnj, safej ? rcp_rn(vvj) : T(0), safej, e,
                inv_e, &g);
      acc_in.x -= g.x;
      acc_in.y -= g.y;
      acc_in.z -= g.z;
    }
  }

  if (live) {
    net[at] = acc_out.x + acc_in.x;
    net[n + at] = acc_out.y + acc_in.y;
    net[2 * n + at] = acc_out.z + acc_in.z;
    cost[at] = c_acc;
  }
}

// Which path a launch takes, by a fixed rule: the staged path wherever its
// block (one warp per active sphere, up to 16) fits in shared memory, else
// the tiled path.  block and smem are the main kernel's launch.
bool selfcol_path_staged(int Sa, int SI, dim3* block, size_t* smem) {
  const int nw = Sa < kMaxWarps ? Sa : kMaxWarps;
  const size_t staged = smem_words(Sa, Sa + SI, nw) * sizeof(float);
  if (staged <= kSmemBlockMax) {
    *block = dim3(kLanes, nw);
    *smem = staged;
    return true;
  }
  *block = dim3(kLanes, kTiledWarps);
  *smem = 0;
  return false;
}

// Allow the dynamic shared memory a launch needs (above the default 48 KB
// only by opting in).
cudaError_t allow_smem(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(selfcol_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// The tiled path: a memset of the pair indices, the setup kernel and the
// main kernel.  scratch holds the (Sa, So) pair indices (int, padded to a
// multiple of sizeof(T) bytes), then the (Sa, So) radius sums and the
// boxes (T; ops/selfcol.py scratch_words).
template <typename T>
int selfcol_tiled(const T* xi, const T* vel, const T* xo, int m, int Sa,
                  int SI, int B, const int* pair_i, const int* pair_j,
                  const T* rsum, int P, const T* eps_self, const T* obs_self,
                  T* net, T* cost, void* scratch, cudaStream_t st) {
  const int tiles = (B + kLanes - 1) / kLanes;
  const int So = Sa + SI;
  constexpr size_t per = sizeof(T) / sizeof(int);
  int* pidx = reinterpret_cast<int*>(scratch);
  T* prs = reinterpret_cast<T*>(pidx + ((size_t)Sa * So + per - 1) / per *
                                           per);
  T* box = prs + (size_t)Sa * So;
  cudaError_t err =
      cudaMemsetAsync(pidx, 0xff, (size_t)Sa * So * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  selfcol_prep_kernel<T>
      <<<dim3(tiles, m), dim3(kLanes, kTiledWarps), 0, st>>>(
          xi, xo, m, Sa, SI, B, pair_i, pair_j, rsum, P, pidx, prs, box);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(tiles, m, (Sa + kTiledWarps - 1) / kTiledWarps);
  selfcol_tiled_kernel<T><<<grid, dim3(kLanes, kTiledWarps), 0, st>>>(
      xi, vel, xo, m, Sa, SI, B, pidx, prs, box, eps_self, obs_self, net,
      cost);
  return (int)cudaGetLastError();
}

// Launch facts of a main kernel fn of `threads` threads and `smem` bytes:
// info[0] threads per block, info[1] dynamic shared memory per block
// (bytes), info[2] resident blocks per SM, info[3] registers per thread,
// info[4] local memory per thread (bytes; non-zero means spills), info[5]
// the path (0 staged, 1 tiled).
int launch_facts(const void* fn, int threads, size_t smem, bool staged,
                 int* info) {
  cudaError_t err = staged ? allow_smem(smem) : cudaSuccess;
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  info[0] = threads;
  info[1] = (int)smem;
  info[2] = blocks;
  info[3] = attr.numRegs;
  info[4] = (int)attr.localSizeBytes;
  info[5] = staged ? 0 : 1;
  return 0;
}

}  // namespace

// scratch: the tiled path's buffer of 2*Sa*So + m*tiles*6*So words (pair
// indices, radius sums, boxes; ops/selfcol.py scratch_words), unused (may
// be null) on the staged path.
extern "C" int cdx_selfcol(const float* xi, const float* vel, const float* xo,
                           int m, int Sa, int SI, int B, const int* pair_i,
                           const int* pair_j, const float* rsum, int P,
                           const float* eps_self, const float* obs_self,
                           float* net, float* cost, float* scratch,
                           void* stream) {
  if (m == 0 || Sa == 0 || B == 0) return 0;
  if (m > 65535) return (int)cudaErrorInvalidConfiguration;
  dim3 block;
  size_t smem;
  cudaStream_t st = (cudaStream_t)stream;
  if (selfcol_path_staged(Sa, SI, &block, &smem)) {
    cudaError_t err = allow_smem(smem);
    if (err != cudaSuccess) return (int)err;
    selfcol_kernel<<<dim3((B + kLanes - 1) / kLanes, m), block, smem, st>>>(
        xi, vel, xo, m, Sa, SI, B, pair_i, pair_j, rsum, P, eps_self,
        obs_self, net, cost);
    return (int)cudaGetLastError();
  }
  return selfcol_tiled(xi, vel, xo, m, Sa, SI, B, pair_i, pair_j, rsum, P,
                       eps_self, obs_self, net, cost, scratch, st);
}

// float64: always the tiled path; scratch of (Sa*So + 1) / 2 * 2 words of
// pair indices, then 2 * (Sa*So + m*tiles*6*So) words of radius sums and
// boxes.
extern "C" int cdx_selfcol_f64(const double* xi, const double* vel,
                               const double* xo, int m, int Sa, int SI, int B,
                               const int* pair_i, const int* pair_j,
                               const double* rsum, int P,
                               const double* eps_self, const double* obs_self,
                               double* net, double* cost, void* scratch,
                               void* stream) {
  if (m == 0 || Sa == 0 || B == 0) return 0;
  if (m > 65535) return (int)cudaErrorInvalidConfiguration;
  return selfcol_tiled(xi, vel, xo, m, Sa, SI, B, pair_i, pair_j, rsum, P,
                       eps_self, obs_self, net, cost, scratch,
                       (cudaStream_t)stream);
}

// Launch facts of the main kernel for Sa active and SI inactive spheres
// (launch_facts).
extern "C" int cdx_selfcol_launch_info(int Sa, int SI, int* info) {
  dim3 block;
  size_t smem;
  const bool staged = selfcol_path_staged(Sa, SI, &block, &smem);
  const void* fn = staged ? (const void*)selfcol_kernel
                          : (const void*)selfcol_tiled_kernel<float>;
  return launch_facts(fn, (int)(block.x * block.y), smem, staged, info);
}

extern "C" int cdx_selfcol_launch_info_f64(int Sa, int SI, int* info) {
  return launch_facts((const void*)selfcol_tiled_kernel<double>,
                      kLanes * kTiledWarps, 0, false, info);
}
