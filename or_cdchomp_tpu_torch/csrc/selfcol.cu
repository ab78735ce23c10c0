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
//  - tiled, beyond: a robot holding a many-sphere body.
//
// What bounds the tiled path on this card: at the grab shape (m = 99,
// Sa = 125, SI = 1, B = 256, 3,617 pairs) the call must move xi, vel, net
// and cost, 126.8 MB, 37.8 us at 3.35 TB/s; of its 2.86 M (point, pair,
// 32-problem) votes 6% pass the box test and 0.9% are taken, so the pair
// math is small and the walk is the work.
//
// What held the first tiled design back: 0.168 ms, 22% of that
// bound, in three launches a call (a memset and a setup kernel that
// rebuilt the dense (Sa, So) pair matrices from the pair table and wrote
// per-tile sphere boxes, then the main kernel).  Its warps read column i
// of those matrices, a stride of So words between lanes: 32 L1 wavefronts
// a load, ~26 M a call.  Once the gathers were gone, timing each warp
// on the card showed the arm spheres near the held body (most of the
// pairs past the box test and taken) running the longest warps, and a
// block waiting for them.
//
// What this design does about it (one launch, ~0.076 ms at the grab):
//  - The pair table is read through a layout built once per table (an
//    engine constant, as the Pallas kernel compiles its pair matrices
//    in): per active sphere the partners it pairs with, in ascending
//    order, 32 to a group, with the group's mask words (one 16-byte
//    broadcast load) and radius sums (coalesced).  A tray sphere's 13
//    partners fill one group where its 32-sphere chunks needed two walks.
//  - A block owns one point and one 32-problem tile.  It stages the
//    positions of all So spheres with cp.async (16 bytes a copy, past L1)
//    into a shared-memory ring, every chunk at once up to 256 spheres (128
//    in float64), and computes each sphere's box over the tile once, one
//    thread per (sphere, component), rotated so a warp reads 32 banks.
//    Past 256 spheres two slots stream the chunks, each round in step.
//  - 16 warps take the block's spheres from a counter in shared memory,
//    in index order, the robot's own spheres first: the long ones start
//    early and the warps finish together.  The counter only hands out
//    spheres; every sphere's sums belong to one warp, in a fixed order, so
//    two launches are bit-equal.  Two blocks share an SM (<= 64
//    registers), one staging while the other walks.
//  - Velocities are read from global memory (past L1) only when a pair in
//    reach needs them; the own sphere's is loaded at its start.
// Tried and measured slower on the card: a persistent double-buffered
// block of 32 warps, the layout rows and the velocities staged in shared
// memory, two pairs a step, and L1 / L2 prefetches of the velocities.
//
// The arithmetic is the Pallas body's: difference form |x_i - x_j|^2 (not
// the expanded form, which cancels in f32), rsqrt(max(d2, 1e-24)) for both
// 1/d and d, the |v| > 1e-6 guard, and the hinge of pallas_selfcol.py.
//
// float64: the tiled path's kernels are templates on the scalar type T,
// and the library exports a float64 entry point (cdx_selfcol_f64) that
// always takes the tiled path, with the same pair math in double (1/sqrt
// from the double rsqrt, not the float MUFU instruction), one block of 16
// warps per SM (~110 registers).  The staged
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

// ---- The tiled path ------------------------------------------------------
//
// Its pair layout is an engine constant (ops/selfcol.py pair_layout builds
// it once per pair table; selfcol_layout_kernel on the card when a call
// brings none).  Per active sphere i, the spheres j it pairs with, as
// (i, j) or as (j, i) with j active, in groups of 32 lanes (G = ceil(So /
// 32) groups a sphere): where the ring holds every chunk (ring_resident),
// the partners in ascending order, compacted; else group g is chunk g,
// lane l sphere 32*g + l.  Per group one 16-byte word of masks, bit l for
// the group's lane l:
//   .x  out     pair (i, j) exists;
//   .y  inonly  pair (j, i) exists (j active) and is not a mirror;
//   .z  mirror  both exist with the same radius sum: d of (j, i) is
//               bit-equal to d of (i, j), so it takes that vote;
//   .w  the number of groups of sphere i that hold a partner;
// the partner j of each lane, and the radius sums of (i, j) and of (j, i)
// by lane (0 where no pair): masks (Sa, G, 4), partners (Sa, G, 32),
// rs (2, Sa, G, 32).

// Layout builder, one block per active sphere i, threads a multiple of 32;
// shared memory: the sphere's out and in bits per 32 spheres and their
// ranks.  Its rows are zeroed, the pair table's bits gathered (atomicOr,
// so the result does not depend on the order), each partner's place in
// the groups ranked, the radius sums and partners scattered there, and the
// words assembled by ballot.
template <typename T>
__global__ void selfcol_layout_kernel(const int* __restrict__ pair_i,
                                      const int* __restrict__ pair_j,
                                      const T* __restrict__ rsum, int P,
                                      int Sa, int So, int compact,
                                      unsigned* masks, int* partners, T* rs) {
  extern __shared__ unsigned sbits[];   // out [G], in [G], base [G]
  const int i = blockIdx.x;
  const int G = (So + kLanes - 1) / kLanes;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  unsigned* sout = sbits;
  unsigned* sin = sbits + G;
  int* sbase = reinterpret_cast<int*>(sbits + 2 * G);
  unsigned* mrow = masks + (size_t)i * G * 4;
  int* prow = partners + (size_t)i * G * kLanes;
  T* r0 = rs + (size_t)i * G * kLanes;
  T* r1 = rs + ((size_t)Sa + i) * G * kLanes;
  for (int q = tid; q < G; q += nt) sout[q] = sin[q] = 0u;
  for (int q = tid; q < G * kLanes; q += nt) {
    prow[q] = compact ? 0 : (q < So ? q : 0);
    r0[q] = r1[q] = T(0);
  }
  __syncthreads();
  for (int p = tid; p < P; p += nt) {
    const int a = pair_i[p];
    const int c = pair_j[p];
    if (a < 0 || a >= Sa || c < 0 || c >= So) continue;
    if (a == i) atomicOr(sout + c / kLanes, 1u << (c % kLanes));
    if (c == i) atomicOr(sin + a / kLanes, 1u << (a % kLanes));
  }
  __syncthreads();
  if (tid == 0) {
    int total = 0;
    for (int q = 0; q < G; ++q) {
      sbase[q] = compact ? total : q * kLanes;
      total += __popc(sout[q] | sin[q]);
    }
  }
  __syncthreads();
  // the place of partner j in the groups
  const auto rank = [&](int j) {
    const unsigned below = (1u << (j % kLanes)) - 1u;
    return sbase[j / kLanes] +
           (compact ? __popc((sout[j / kLanes] | sin[j / kLanes]) & below)
                    : j % kLanes);
  };
  for (int p = tid; p < P; p += nt) {
    const int a = pair_i[p];
    const int c = pair_j[p];
    if (a < 0 || a >= Sa || c < 0 || c >= So) continue;
    if (a == i) r0[rank(c)] = rsum[p];
    if (c == i) r1[rank(a)] = rsum[p];
  }
  for (int j = tid; j < G * kLanes; j += nt)
    if (compact && j < So &&
        (((sout[j / kLanes] | sin[j / kLanes]) >> (j % kLanes)) & 1u))
      prow[rank(j)] = j;
  __syncthreads();
  int groups = 0;
  for (int q = 0; q < G; ++q) groups += __popc(sout[q] | sin[q]);
  groups = compact ? (groups + kLanes - 1) / kLanes : G;
  for (int q = tid; q < G * kLanes; q += nt) {   // a warp: one group
    const int j = prow[q];
    const bool live = compact ? q < sbase[G - 1] + __popc(sout[G - 1] |
                                                          sin[G - 1])
                              : q < So;
    const bool out = live && ((sout[j / kLanes] >> (j % kLanes)) & 1u);
    const bool in = live && ((sin[j / kLanes] >> (j % kLanes)) & 1u);
    const bool mirror = out && in && r0[q] == r1[q];
    const unsigned wo = __ballot_sync(kFull, out);
    const unsigned wi = __ballot_sync(kFull, in);
    const unsigned wm = __ballot_sync(kFull, mirror);
    if (q % kLanes == 0) {
      unsigned* wd = mrow + q / kLanes * 4;
      wd[0] = wo;
      wd[1] = wi & ~wm;
      wd[2] = wm;
      wd[3] = (unsigned)groups;
    }
  }
}

// A tiled block: 16 warps (own active spheres); in float at most 64
// registers a thread, so that two blocks share an SM, in double one block
// (~110 registers).
template <typename T>
struct Tiled {
  static constexpr int kWarps = 16;
  static constexpr int kThreads = kWarps * kLanes;
  static constexpr int kBlocks = sizeof(T) == sizeof(float) ? 2 : 1;
};
// one ring slot: a 32-sphere chunk's positions [3][32 spheres][32 problems]
// and its spheres' boxes over the tile [6][32] (low corner, high corner)
constexpr int kBoxAt = 3 * kLanes * kLanes;
constexpr int kSlotWords = kBoxAt + 6 * kLanes;
// the ring's budget: 8 float32 (4 float64) slots, two blocks per SM
constexpr size_t kRingBytesMax = 8 * kSlotWords * sizeof(float);

// Whether a tiled block keeps every chunk of its work item in its ring:
// where they fit in kRingBytesMax, up to 256 spheres in float32 (128 in
// float64); else it has two slots, through which each round streams the
// chunks.  ops/selfcol.py ring_resident mirrors it.
__host__ __device__ inline bool ring_resident(int So, size_t item) {
  const int nch = (So + kLanes - 1) / kLanes;
  return (size_t)nch * kSlotWords * item <= kRingBytesMax;
}

// Dynamic shared memory of a tiled block: its ring (ops/selfcol.py
// tiled_smem).
inline size_t tiled_smem(int So, size_t item) {
  const int nch = (So + kLanes - 1) / kLanes;
  return (size_t)(ring_resident(So, item) ? nch : 2) * kSlotWords * item;
}

// cp.async of one float or double (N = sizeof(T)) into shared memory, or
// of 16 bytes past L1 (.cg), so that the staged positions do not evict the
// pair layout from L1; an invalid copy reads nothing and writes zeros.
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
                 "l"(src), "n"(N), "r"(valid ? N : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The whole block starts the copy of chunk ch's positions at point k over
// problem tile `tile` into a ring slot: active spheres from xi, inactive
// ones from xo, coalesced (consecutive threads, consecutive problems), 16
// bytes a copy where `vec` (B a multiple of 16 / sizeof(T), 16-byte
// aligned tensors), else one float a copy.
template <typename T>
__device__ __forceinline__ void stage_chunk(T* slot, const T* __restrict__ xi,
                                            const T* __restrict__ xo,
                                            long long n, long long no, int Sa,
                                            int So, int k, int B, int tile,
                                            int ch, bool vec) {
  constexpr int V = 16 / sizeof(T);
  const int nt = blockDim.x * blockDim.y;
  const int step = vec ? V : 1;
  for (int e = (threadIdx.y * kLanes + threadIdx.x) * step; e < kBoxAt;
       e += nt * step) {
    const int s = ch * kLanes + (e / kLanes) % kLanes;
    const int c = e / (kLanes * kLanes);
    const int b = tile * kLanes + e % kLanes;
    const bool valid = s < So && b < B;
    const T* src = xi;
    if (valid)
      src = s < Sa ? xi + c * n + ((long long)k * Sa + s) * B + b
                   : xo + c * no + (long long)(s - Sa) * B + b;
    if (vec)
      cp_async<16>(slot + e, src, valid);
    else
      cp_async<sizeof(T)>(slot + e, src, valid);
  }
}

// The boxes over the live problems of the 32 chunk spheres of `nslots`
// consecutive ring slots, each slot's [6][32] low and high corners: one
// thread per (slot, component, sphere s) walks the 32 problems starting at
// problem s, so a warp's 32 spheres read 32 banks.
template <typename T>
__device__ __forceinline__ void stage_boxes(T* slots, int nslots, int tile,
                                            int B) {
  const int live = min(kLanes, B - tile * kLanes);   // live problems
  const int nt = blockDim.x * blockDim.y;
  for (int q = threadIdx.y * kLanes + threadIdx.x; q < nslots * 3 * kLanes;
       q += nt) {
    const int s = q % kLanes;
    const int c = q / kLanes % 3;
    T* slot = slots + q / (3 * kLanes) * kSlotWords;
    const T* row = slot + (c * kLanes + s) * kLanes;
    T lo = T(INFINITY), hi = T(-INFINITY);
    for (int t = 0; t < kLanes; ++t) {
      const int l = (s + t) % kLanes;
      if (l < live) {
        lo = mfmin(lo, row[l]);
        hi = mfmax(hi, row[l]);
      }
    }
    slot[kBoxAt + c * kLanes + s] = lo;
    slot[kBoxAt + (3 + c) * kLanes + s] = hi;
  }
}

// Position of chunk sphere q of a slot for this lane's problem.
template <typename T>
__device__ __forceinline__ V3<T> slot_pos(const T* slot, int q, int lane) {
  return {slot[q * kLanes + lane], slot[(kLanes + q) * kLanes + lane],
          slot[(2 * kLanes + q) * kLanes + lane]};
}

// The tiled path, a grid of work items (point k, 32-problem tile, z-group
// z), z fastest, one a block of 32 x 16 threads; lane l owns problem
// 32*tile + l.  The block stages the positions of all So spheres 32 at a
// time in shared memory, with each chunk sphere's box over the tile
// computed once.  kResident: every chunk at once, and the warps take the
// block's active spheres z + zg*t, t = 0, 1, ..., from a counter; else two
// slots through which each round streams the chunks, and in round r warp
// w owns sphere (r*zg + z)*16 + w.  Each warp walks its sphere's partner
// groups (the pair layout through L1): lane l tests the group's lane-l
// partner j (its box and radius sum) for every problem of the tile at
// once, then the
// pairs in reach get the pair math, with the same votes and arithmetic as
// the staged kernel.  Its own and the partners' velocities are read from
// global memory when a pair in reach first needs them.  Sum order: per
// sphere, outgoing pairs in ascending j into one register sum, incoming
// pairs in ascending j into another, added at the end, as the staged
// kernel sums them.
template <typename T, bool kResident>
__global__ void __launch_bounds__(Tiled<T>::kThreads, Tiled<T>::kBlocks)
selfcol_tiled_kernel(const T* __restrict__ xi, const T* __restrict__ vel,
                     const T* __restrict__ xo, int m, int Sa, int SI, int B,
                     const uint4* __restrict__ masks,
                     const int* __restrict__ partners,
                     const T* __restrict__ rs,
                     const T* __restrict__ eps_self,
                     const T* __restrict__ obs_self, T* __restrict__ net,
                     T* __restrict__ cost, int zg, int rounds, bool vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const ring = reinterpret_cast<T*>(smem_raw);
  const int So = Sa + SI;
  const int G = (So + kLanes - 1) / kLanes;
  const int tiles = (B + kLanes - 1) / kLanes;
  const int lane = threadIdx.x;
  const int w = threadIdx.y;
  const int nw = blockDim.y;
  const int z = blockIdx.x % zg;
  const int tile = blockIdx.x / zg % tiles;
  const int k = blockIdx.x / (zg * tiles);
  const int b = tile * kLanes + lane;
  const bool live = b < B;          // dead lanes vote "out of reach"
  const long long n = (long long)m * Sa * B;   // component stride of xi
  const long long no = (long long)SI * B;      // component stride of xo
  const T e = live ? eps_self[b] : T(1);
  const T inv_e = rcp_rn(e);
  const T ofs = live ? obs_self[b] : T(0);
  const T emax = warp_max(e, live);   // the largest eps of the tile

  // resident: the next of the block's spheres z + zg*t a warp takes
  __shared__ int next_t;
  if constexpr (kResident) {
    if (lane == 0 && w == 0) next_t = nw;
    for (int ch = 0; ch < G; ++ch)
      stage_chunk(ring + ch * kSlotWords, xi, xo, n, no, Sa, So, k, B, tile,
                  ch, vec);
    cp_async_wait_all();
    __syncthreads();
    stage_boxes(ring, G, tile, B);
    __syncthreads();
  }

  int t = w;
  for (int r = 0; kResident || r < rounds; ++r) {
    // resident: sphere z + zg*t, then the next one free; streamed: the
    // rounds in step (the chunks stream past every warp at once)
    const int i = kResident ? z + zg * t : (r * zg + z) * nw + w;
    const bool mine = i < Sa;       // a whole warp
    if (kResident && !mine) break;
    const long long at = ((long long)k * Sa + i) * B + b;
    V3<T> xs = {0, 0, 0}, vs = {0, 0, 0};
    T lo_i[3], hi_i[3];
    if (mine) {
      if (live)                     // read once: past L1
        vs = {__ldcg(vel + at), __ldcg(vel + n + at),
              __ldcg(vel + 2 * n + at)};
      if constexpr (kResident) {    // sphere i and its box, staged above
        const T* own = ring + (i / kLanes) * kSlotWords;
        xs = slot_pos(own, i % kLanes, lane);
        for (int c = 0; c < 3; ++c) {
          lo_i[c] = own[kBoxAt + c * kLanes + i % kLanes];
          hi_i[c] = own[kBoxAt + (3 + c) * kLanes + i % kLanes];
        }
      } else {
        if (live)
          xs = {__ldg(xi + at), __ldg(xi + n + at), __ldg(xi + 2 * n + at)};
        const T xc[3] = {xs.x, xs.y, xs.z};
        for (int c = 0; c < 3; ++c) {
          lo_i[c] = -warp_max(-xc[c], live);
          hi_i[c] = warp_max(xc[c], live);
        }
      }
    }
    const size_t row = (size_t)(mine ? i : 0) * G;
    const uint4* mrow = masks + row;
    const int* prow = partners + row * kLanes;
    const T* r0 = rs + row * kLanes;
    const T* r1 = r0 + (size_t)Sa * G * kLanes;
    // resident: the groups that hold a partner; streamed: every chunk
    const int groups = kResident ? (mine ? (int)__ldg(mrow).w : 0) : G;
    V3<T> acc_out = {0, 0, 0}, acc_in = {0, 0, 0};
    T c_acc = 0;

    if constexpr (!kResident)
      stage_chunk(ring, xi, xo, n, no, Sa, So, k, B, tile, 0, vec);
    for (int g = 0; g < groups; ++g) {
      const T* cur = ring + (g & 1) * kSlotWords;   // streamed: chunk g
      if constexpr (!kResident) {
        cp_async_wait_all();
        __syncthreads();            // chunk g staged; chunk g - 1 done
        if (g + 1 < G)
          stage_chunk(ring + ((g + 1) & 1) * kSlotWords, xi, xo, n, no, Sa,
                      So, k, B, tile, g + 1, vec);
        stage_boxes(ring + (g & 1) * kSlotWords, 1, tile, B);
        __syncthreads();
      }
      if (!mine) continue;
      const uint4 mw = __ldg(mrow + g);
      if ((mw.x | mw.y) == 0u) continue;
      // pair (i, j) outgoing, pair (j, i) incoming with j active: lane l
      // tests partner j; a mirror's radius sum is rs_out
      const int j = __ldg(prow + g * kLanes + lane);
      const T* jslot = kResident ? ring + (j / kLanes) * kSlotWords : cur;
      const bool out = (mw.x >> lane) & 1u;
      const bool inonly = (mw.y >> lane) & 1u;
      const T rs_out = out ? __ldg(r0 + g * kLanes + lane) : T(0);
      const T rs_in = inonly ? __ldg(r1 + g * kLanes + lane) : rs_out;
      T g2 = 0;
      for (int c = 0; c < 3; ++c) {   // the gap is symmetric in (i, j)
        const T lo_j = jslot[kBoxAt + c * kLanes + j % kLanes];
        const T hi_j = jslot[kBoxAt + (3 + c) * kLanes + j % kLanes];
        const T gap = mfmax(T(0), mfmax(lo_j - hi_i[c], lo_i[c] - hi_j));
        g2 = fma_rn(gap, gap, g2);
      }
      const T r_out = (emax + rs_out) * (T(1) + T(1e-4)) + T(1e-6);
      const T r_in = (emax + rs_in) * (T(1) + T(1e-4)) + T(1e-6);
      const bool near_out = out && g2 <= r_out * r_out;
      const bool near_in = inonly && g2 <= r_in * r_in;

      // the position of lane q's partner for this lane's problem
      const auto partner_pos = [&](int q) {
        const int jq = __shfl_sync(kFull, j, q);
        const T* s = kResident ? ring + (jq / kLanes) * kSlotWords : cur;
        return slot_pos(s, jq % kLanes, lane);
      };
      unsigned taken = 0u;
      for (unsigned bits = __ballot_sync(kFull, near_out); bits;
           bits &= bits - 1u) {
        const int q = __ffs(bits) - 1;
        const PairDist<T> p = distance(xs, partner_pos(q),
                                       __shfl_sync(kFull, rs_out, q));
        if (!__any_sync(kFull, live && p.d <= e)) continue;
        taken |= 1u << q;
        const T vv = fma_rn(vs.z, vs.z, fma_rn(vs.y, vs.y, vs.x * vs.x));
        const T vn = msqrt(vv);
        const bool safe = vn > T(1e-6);
        V3<T> gr;
        c_acc += pair_grad(p, vs, ofs * vn, safe ? rcp_rn(vv) : T(0), safe,
                           e, inv_e, &gr);
        acc_out.x += gr.x;
        acc_out.y += gr.y;
        acc_out.z += gr.z;
      }
      taken &= mw.z;
      for (unsigned bits = __ballot_sync(kFull, near_in); bits;
           bits &= bits - 1u) {
        const int q = __ffs(bits) - 1;
        const PairDist<T> p = distance(partner_pos(q), xs,
                                       __shfl_sync(kFull, rs_in, q));
        taken |= (unsigned)(__any_sync(kFull, live && p.d <= e) != 0) << q;
      }
      for (; taken; taken &= taken - 1u) {
        const int q = __ffs(taken) - 1;
        const int jq = __shfl_sync(kFull, j, q);
        const T rs_q = __shfl_sync(kFull, rs_in, q);
        V3<T> vj = {0, 0, 0};
        if (live) {
          const long long aj = ((long long)k * Sa + jq) * B + b;
          vj = {__ldcg(vel + aj), __ldcg(vel + n + aj),
                __ldcg(vel + 2 * n + aj)};
        }
        const T vvj = fma_rn(vj.z, vj.z, fma_rn(vj.y, vj.y, vj.x * vj.x));
        const T vnj = msqrt(vvj);
        const bool safej = vnj > T(1e-6);
        const PairDist<T> p = distance(partner_pos(q), xs, rs_q);
        V3<T> gr;
        pair_grad(p, vj, ofs * vnj, safej ? rcp_rn(vvj) : T(0), safej, e,
                  inv_e, &gr);
        acc_in.x -= gr.x;
        acc_in.y -= gr.y;
        acc_in.z -= gr.z;
      }
    }
    if (mine && live) {
      net[at] = acc_out.x + acc_in.x;
      net[n + at] = acc_out.y + acc_in.y;
      net[2 * n + at] = acc_out.z + acc_in.z;
      cost[at] = c_acc;
    }
    if constexpr (kResident) {
      if (lane == 0) t = atomicAdd(&next_t, 1);
      t = __shfl_sync(kFull, t, 0);
    } else {
      __syncthreads();              // slot 0: next round
    }
  }
}

// Which path a launch takes, by a fixed rule: the staged path wherever its
// block (one warp per active sphere, up to 16) fits in shared memory, else
// the tiled path.  block and smem are the float32 launch.
bool selfcol_path_staged(int Sa, int SI, dim3* block, size_t* smem) {
  const int nw = Sa < kMaxWarps ? Sa : kMaxWarps;
  const size_t staged = smem_words(Sa, Sa + SI, nw) * sizeof(float);
  if (staged <= kSmemBlockMax) {
    *block = dim3(kLanes, nw);
    *smem = staged;
    return true;
  }
  *block = dim3(kLanes, Tiled<float>::kWarps);
  *smem = tiled_smem(Sa + SI, sizeof(float));
  return false;
}

// Allow the dynamic shared memory a launch of fn needs (above the default
// 48 KB only by opting in).
cudaError_t allow_smem(const void* fn, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// The tiled path: one launch, a block per work item.  Enough z-groups of
// warps that the grid fills every SM's Tiled<T>::kBlocks blocks where
// m * tiles falls short; each warp takes `rounds` active spheres in turn.
template <typename T>
int selfcol_tiled(const T* xi, const T* vel, const T* xo, int m, int Sa,
                  int SI, int B, const unsigned* masks, const int* partners,
                  const T* rs, const T* eps_self, const T* obs_self, T* net,
                  T* cost, cudaStream_t st) {
  if (masks == nullptr || partners == nullptr || rs == nullptr)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  constexpr int nw = Tiled<T>::kWarps;
  const long long blocks = (long long)sms * Tiled<T>::kBlocks;
  const long long cells = (long long)m * ((B + kLanes - 1) / kLanes);
  const int groups = (Sa + nw - 1) / nw;
  const long long want = (blocks + cells - 1) / cells;
  const int zg = (int)(want < groups ? want : groups);
  const int rounds = (groups + zg - 1) / zg;
  if (cells * zg > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = tiled_smem(Sa + SI, sizeof(T));
  const auto aligned = [](const void* p) {
    return p == nullptr || reinterpret_cast<size_t>(p) % 16 == 0;
  };
  const bool vec = B % (16 / sizeof(T)) == 0 && aligned(xi) && aligned(xo);
  auto* fn = ring_resident(Sa + SI, sizeof(T))
                 ? selfcol_tiled_kernel<T, true>
                 : selfcol_tiled_kernel<T, false>;
  err = allow_smem((const void*)fn, smem);
  if (err != cudaSuccess) return (int)err;
  fn<<<(unsigned)(cells * zg), dim3(kLanes, nw), smem, st>>>(
      xi, vel, xo, m, Sa, SI, B, reinterpret_cast<const uint4*>(masks),
      partners, rs, eps_self, obs_self, net, cost, zg, rounds, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int selfcol_layout(const int* pair_i, const int* pair_j, const T* rsum,
                   int P, int Sa, int So, unsigned* masks, int* partners,
                   T* rs, cudaStream_t st) {
  if (Sa == 0) return 0;
  const int G = (So + kLanes - 1) / kLanes;
  const size_t smem = (size_t)3 * G * sizeof(unsigned);
  cudaError_t err = allow_smem((const void*)selfcol_layout_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  selfcol_layout_kernel<T><<<Sa, 256, smem, st>>>(
      pair_i, pair_j, rsum, P, Sa, So, ring_resident(So, sizeof(T)), masks,
      partners, rs);
  return (int)cudaGetLastError();
}

// Launch facts of a main kernel fn of `threads` threads and `smem` bytes:
// info[0] threads per block, info[1] dynamic shared memory per block
// (bytes), info[2] resident blocks per SM, info[3] registers per thread,
// info[4] local memory per thread (bytes; non-zero means spills), info[5]
// the path (0 staged, 1 tiled).
int launch_facts(const void* fn, int threads, size_t smem, bool staged,
                 int* info) {
  cudaError_t err = allow_smem(fn, smem);
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

// launch_facts of the tiled kernel that a launch for Sa active and SI
// inactive spheres takes.
template <typename T>
int tiled_facts(int Sa, int SI, int* info) {
  const void* fn = ring_resident(Sa + SI, sizeof(T))
                       ? (const void*)selfcol_tiled_kernel<T, true>
                       : (const void*)selfcol_tiled_kernel<T, false>;
  return launch_facts(fn, Tiled<T>::kThreads,
                      tiled_smem(Sa + SI, sizeof(T)), false, info);
}

}  // namespace

// masks, partners, rs: the tiled path's pair layout (ops/selfcol.py
// pair_layout), unused (may be null) on the staged path.
extern "C" int cdx_selfcol(const float* xi, const float* vel, const float* xo,
                           int m, int Sa, int SI, int B, const int* pair_i,
                           const int* pair_j, const float* rsum, int P,
                           const float* eps_self, const float* obs_self,
                           float* net, float* cost, const unsigned* masks,
                           const int* partners, const float* rs,
                           void* stream) {
  if (m == 0 || Sa == 0 || B == 0) return 0;
  if (m > 65535) return (int)cudaErrorInvalidConfiguration;
  dim3 block;
  size_t smem;
  cudaStream_t st = (cudaStream_t)stream;
  if (selfcol_path_staged(Sa, SI, &block, &smem)) {
    cudaError_t err = allow_smem((const void*)selfcol_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    selfcol_kernel<<<dim3((B + kLanes - 1) / kLanes, m), block, smem, st>>>(
        xi, vel, xo, m, Sa, SI, B, pair_i, pair_j, rsum, P, eps_self,
        obs_self, net, cost);
    return (int)cudaGetLastError();
  }
  return selfcol_tiled(xi, vel, xo, m, Sa, SI, B, masks, partners, rs,
                       eps_self, obs_self, net, cost, st);
}

// float64: always the tiled path.
extern "C" int cdx_selfcol_f64(const double* xi, const double* vel,
                               const double* xo, int m, int Sa, int SI, int B,
                               const int* pair_i, const int* pair_j,
                               const double* rsum, int P,
                               const double* eps_self, const double* obs_self,
                               double* net, double* cost,
                               const unsigned* masks, const int* partners,
                               const double* rs, void* stream) {
  if (m == 0 || Sa == 0 || B == 0) return 0;
  if (m > 65535) return (int)cudaErrorInvalidConfiguration;
  return selfcol_tiled(xi, vel, xo, m, Sa, SI, B, masks, partners, rs,
                       eps_self, obs_self, net, cost, (cudaStream_t)stream);
}

// The tiled path's pair layout from the pair table, one launch: masks
// (Sa, G, 4) words, partners (Sa, G, 32) and rs (2, Sa, G, 32), G =
// ceil(So / 32).
extern "C" int cdx_selfcol_layout(const int* pair_i, const int* pair_j,
                                  const float* rsum, int P, int Sa, int So,
                                  unsigned* masks, int* partners, float* rs,
                                  void* stream) {
  return selfcol_layout(pair_i, pair_j, rsum, P, Sa, So, masks, partners,
                        rs, (cudaStream_t)stream);
}

extern "C" int cdx_selfcol_layout_f64(const int* pair_i, const int* pair_j,
                                      const double* rsum, int P, int Sa,
                                      int So, unsigned* masks, int* partners,
                                      double* rs, void* stream) {
  return selfcol_layout(pair_i, pair_j, rsum, P, Sa, So, masks, partners,
                        rs, (cudaStream_t)stream);
}

// Launch facts of the main kernel for Sa active and SI inactive spheres
// (launch_facts).
extern "C" int cdx_selfcol_launch_info(int Sa, int SI, int* info) {
  dim3 block;
  size_t smem;
  if (selfcol_path_staged(Sa, SI, &block, &smem))
    return launch_facts((const void*)selfcol_kernel, (int)(block.x * block.y),
                        smem, true, info);
  return tiled_facts<float>(Sa, SI, info);
}

extern "C" int cdx_selfcol_launch_info_f64(int Sa, int SI, int* info) {
  return tiled_facts<double>(Sa, SI, info);
}
