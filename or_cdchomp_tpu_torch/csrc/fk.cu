// Structure-of-arrays forward kinematics of a batched trajectory in one
// launch: CompiledFK.fk_soa (or_cdchomp_tpu_torch/models/robot.py) on a
// CUDA tensor.
//
// No Pallas kernel is replaced: the JAX package computes this FK in plain
// jnp (or_cdchomp_tpu/models/robot.py, CompiledFK.fk_soa) and XLA fuses
// the chain.  In eager PyTorch the same chain is some 650 small aten
// launches (a qmul, qrot or add per component and joint), each on a
// (n_points, B) slice: the replayed step paid the floor of a dependent
// graph node for each, some 0.9 ms at B = 256, for work of a few
// microseconds.
//
// What bounds it on the H100: the stores.  Per (point, problem) the thread
// reads its n_dof joint values and its 7 base values and writes
// 3 S + 10 D + 7 n_red values (x; anch_pos, anch_q, axis_w; red_pos,
// red_q): 171 for the solver's WAM7 FK (S = 15 active spheres, D = 7,
// n_red = 8), 17.7 MB at 101 points x 256 problems in float32 (5.3 us at
// 3.35 TB/s) and 0.71 GB at 101 x 10,240 (0.21 ms).  The arithmetic,
// about 60 operations a joint and 20 a sphere, is far below the card's
// rate.
//
// What the design does about it:
//  - One thread per (point, problem), the problem index fastest, so each
//    of the thread's stores is one coalesced line per warp in the
//    (c, n_points, K, B) layout every consumer reads; one launch for the
//    whole chain.  The inputs come through strides: qT as
//    sphere_kinematics passes it (a permuted view of the trajectory) and
//    each base component broadcast to (n_points, B) (stride 0 where it
//    does not vary), so the wrapper copies nothing.
//  - The robot is data: a packed table in the FK's dtype (ops/fk.py
//    pack_table: per chain entry its parent slot, DOF, joint type,
//    rot_id / pos_zero flags, axis and constant offset K; per reduced slot
//    the range of its spheres, sorted by slot; per sphere its index and
//    folded offset), staged in shared memory by each block.  A table
//    is at most the 48 KB a block may take without opting in (ops/fk.py
//    TABLE_BYTES_MAX refuses a larger one; WAM7's is ~0.7 KB, the
//    126-sphere grab tray's ~2.5 KB): read from shared memory, every
//    thread's reads of one word at one address are a broadcast, and the
//    kernel takes 9.6 us at 101 points x 256 problems against 12.2 us
//    reading the table from global memory (15.0 against 22.4 us at the
//    float64 check's 84 x 1; the same at 101 x 10,240, where the stores
//    hide it).
//  - The walk keeps the last pose in registers: a serial chain (the
//    parent is the previous slot) never reads a pose back.  Any other
//    parent is read back from the thread's own red_pos / red_q stores, so
//    the number of slots has no cap.  Each slot's spheres are written as
//    soon as its pose is known.
//
// Numerics: the formulas of ops/soa.py in the same association, the
// two-cross qrot, the Hamilton qmul, sin / cos of half the angle, and
// the skips where rot_id or pos_zero (built with -fmad=false, so no
// product is fused into a sum).  The constants are the table's words, the
// FK dtype's rounding of the float64 chain, as the plain version's
// Python scalars are rounded to its tensors' dtype.  The plain versions
// are CompiledFK.fk_soa_plain and, reading the same table,
// ops/fk.py fk_soa_table_ref.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kEntryWords = 15;    // ops/fk.py ENTRY_WORDS
constexpr int kSphereWords = 4;    // ops/fk.py SPHERE_WORDS
constexpr int kRevolute = 1;       // models/robot.py REVOLUTE

// the 7 base components (x, y, z, qx, qy, qz, qw), each read at
// p * sp[c] + b * sb[c]
template <typename T>
struct Base {
  const T* ptr[7];
  int64_t sp[7];
  int64_t sb[7];
};

template <typename T>
struct Pose {
  T px, py, pz, qx, qy, qz, qw;
};

// a qmul b (ops/soa.py qmul)
template <typename T>
__device__ __forceinline__ void qmul(T ax, T ay, T az, T aw, T bx, T by,
                                     T bz, T bw, T& x, T& y, T& z, T& w) {
  x = aw * bx + ax * bw + ay * bz - az * by;
  y = aw * by - ax * bz + ay * bw + az * bx;
  z = aw * bz + ax * by - ay * bx + az * bw;
  w = aw * bw - ax * bx - ay * by - az * bz;
}

// v rotated by q: v + w t + q x t with t = 2 (q x v) (ops/soa.py qrot and
// qrot_const, which round alike)
template <typename T>
__device__ __forceinline__ void qrot(T qx, T qy, T qz, T qw, T vx, T vy,
                                     T vz, T& x, T& y, T& z) {
  const T tx = (qy * vz - qz * vy) * T(2);
  const T ty = (qz * vx - qx * vz) * T(2);
  const T tz = (qx * vy - qy * vx) * T(2);
  x = vx + tx * qw + (qy * tz - qz * ty);
  y = vy + ty * qw + (qz * tx - qx * tz);
  z = vz + tz * qw + (qx * ty - qy * tx);
}

template <typename T>
__device__ __forceinline__ T sin_of(T v);
template <>
__device__ __forceinline__ float sin_of<float>(float v) { return sinf(v); }
template <>
__device__ __forceinline__ double sin_of<double>(double v) { return sin(v); }
template <typename T>
__device__ __forceinline__ T cos_of(T v);
template <>
__device__ __forceinline__ float cos_of<float>(float v) { return cosf(v); }
template <>
__device__ __forceinline__ double cos_of<double>(double v) { return cos(v); }

// One (c, n_points, K, B) output: component c of row k at this thread's
// (point, problem) lies at c * stride + k * B + at.
template <typename T>
struct Out {
  T* base;
  int64_t stride;   // n_points K B
  int64_t at;       // p K B + b
  int64_t B;
  __device__ __forceinline__ T& operator()(int c, int k) const {
    return base[c * stride + k * B + at];
  }
};

template <typename T>
__device__ __forceinline__ void store_pose(const Out<T>& rp, const Out<T>& rq,
                                           int r, const Pose<T>& s) {
  rp(0, r) = s.px;
  rp(1, r) = s.py;
  rp(2, r) = s.pz;
  rq(0, r) = s.qx;
  rq(1, r) = s.qy;
  rq(2, r) = s.qz;
  rq(3, r) = s.qw;
}

// the spheres of reduced slot r (table order), at that slot's pose
template <typename T>
__device__ __forceinline__ void spheres(const T* __restrict__ start,
                                        const T* __restrict__ sph, int r,
                                        const Pose<T>& s, const Out<T>& x) {
  const int lo = (int)start[r];
  const int hi = (int)start[r + 1];
  for (int i = lo; i < hi; ++i) {
    const T* w = sph + i * kSphereWords;
    T rx, ry, rz;
    qrot(s.qx, s.qy, s.qz, s.qw, w[1], w[2], w[3], rx, ry, rz);
    const int k = (int)w[0];
    x(0, k) = rx + s.px;
    x(1, k) = ry + s.py;
    x(2, k) = rz + s.pz;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fk_soa_kernel(const T* __restrict__ q, int64_t qp, int64_t qd,
                  int64_t qb, Base<T> base, const T* __restrict__ table,
                  int words, int E, int S, int D, int P, int B,
                  T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tab = reinterpret_cast<T*>(smem_raw);
  for (int i = threadIdx.x; i < words; i += kThreads) tab[i] = table[i];
  __syncthreads();
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (int64_t)P * B) return;
  const int p = (int)(t / B);
  const int b = (int)(t - (int64_t)p * B);
  const int R = E + 1;
  const T* start = tab + E * kEntryWords;
  const T* sph = start + R + 1;

  const int64_t pb = (int64_t)P * B;
  const Out<T> x{out, pb * S, (int64_t)p * S * B + b, B};
  T* o = out + 3 * pb * S;
  const Out<T> ap{o, pb * D, (int64_t)p * D * B + b, B};
  const Out<T> aq{o + 3 * pb * D, pb * D, ap.at, B};
  const Out<T> aw{o + 7 * pb * D, pb * D, ap.at, B};
  o += 10 * pb * D;
  const Out<T> rp{o, pb * R, (int64_t)p * R * B + b, B};
  const Out<T> rq{o + 3 * pb * R, pb * R, rp.at, B};

  const auto at = [&](int c) {
    return base.ptr[c][(int64_t)p * base.sp[c] + (int64_t)b * base.sb[c]];
  };
  Pose<T> s{at(0), at(1), at(2), at(3), at(4), at(5), at(6)};
  store_pose(rp, rq, 0, s);
  spheres(start, sph, 0, s, x);
  int slot = 0;   // the reduced slot whose pose s holds

  const T* qrow = q + (int64_t)p * qp + (int64_t)b * qb;
  for (int e = 0; e < E; ++e) {
    const T* w = tab + e * kEntryWords;
    const int parent = (int)w[0];
    if (parent != slot) {   // read the parent back from this thread's stores
      s.px = rp(0, parent);
      s.py = rp(1, parent);
      s.pz = rp(2, parent);
      s.qx = rq(0, parent);
      s.qy = rq(1, parent);
      s.qz = rq(2, parent);
      s.qw = rq(3, parent);
    }
    const int d = (int)w[1];
    const T ax = w[5], ay = w[6], az = w[7];
    // the joint frame before its motion: parent o K
    T ox = s.qx, oy = s.qy, oz = s.qz, ow = s.qw;
    if (w[3] == T(0))
      qmul(s.qx, s.qy, s.qz, s.qw, w[11], w[12], w[13], w[14], ox, oy, oz,
           ow);
    T px = s.px, py = s.py, pz = s.pz;
    if (w[4] == T(0)) {
      T kx, ky, kz;
      qrot(s.qx, s.qy, s.qz, s.qw, w[8], w[9], w[10], kx, ky, kz);
      px = s.px + kx;
      py = s.py + ky;
      pz = s.pz + kz;
    }
    ap(0, d) = px;
    ap(1, d) = py;
    ap(2, d) = pz;
    aq(0, d) = ox;
    aq(1, d) = oy;
    aq(2, d) = oz;
    aq(3, d) = ow;
    T wx, wy, wz;
    qrot(ox, oy, oz, ow, ax, ay, az, wx, wy, wz);
    aw(0, d) = wx;
    aw(1, d) = wy;
    aw(2, d) = wz;
    const T v = qrow[(int64_t)d * qd];
    if ((int)w[2] == kRevolute) {
      const T h = T(0.5) * v;
      const T sn = sin_of(h);
      const T cs = cos_of(h);
      qmul(ox, oy, oz, ow, sn * ax, sn * ay, sn * az, cs, s.qx, s.qy, s.qz,
           s.qw);
      s.px = px;
      s.py = py;
      s.pz = pz;
    } else {   // prismatic: along the world axis
      s.px = px + wx * v;
      s.py = py + wy * v;
      s.pz = pz + wz * v;
      s.qx = ox;
      s.qy = oy;
      s.qz = oz;
      s.qw = ow;
    }
    slot = e + 1;
    store_pose(rp, rq, slot, s);
    spheres(start, sph, slot, s, x);
  }
}

template <typename T>
int launch(const T* q, const int64_t* qs, const void* const* bptr,
           const int64_t* bstr, const T* table, int words, int E, int S,
           int D, int P, int B, T* out, void* stream) {
  const int64_t n = (int64_t)P * B;
  if (n == 0) return 0;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  Base<T> base;
  for (int c = 0; c < 7; ++c) {
    base.ptr[c] = static_cast<const T*>(bptr[c]);
    base.sp[c] = bstr[2 * c];
    base.sb[c] = bstr[2 * c + 1];
  }
  // the table in shared memory: past 48 KB the launch itself fails
  fk_soa_kernel<T><<<(unsigned)blocks, kThreads, (size_t)words * sizeof(T),
                      (cudaStream_t)stream>>>(q, qs[0], qs[1], qs[2], base,
                                              table, words, E, S, D, P, B,
                                              out);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (P, D, B) joint values read at p qs[0] + d qs[1] + b qs[2];
// bptr: the 7 base components, each read at p bstr[2c] + b bstr[2c + 1];
// table: ops/fk.py pack_table's words (words of them), E chain entries;
// out: the (3 S + 10 D + 7 (E + 1)) P B outputs, in the order x, anch_pos,
// anch_q, axis_w, red_pos, red_q, each (c, P, K, B).
extern "C" int cdx_fk_soa(const float* q, const int64_t* qs,
                          const void* const* bptr, const int64_t* bstr,
                          const float* table, int words, int E, int S, int D,
                          int P, int B, float* out, void* stream) {
  return launch<float>(q, qs, bptr, bstr, table, words, E, S, D, P, B, out,
                       stream);
}

extern "C" int cdx_fk_soa_f64(const double* q, const int64_t* qs,
                              const void* const* bptr, const int64_t* bstr,
                              const double* table, int words, int E, int S,
                              int D, int P, int B, double* out,
                              void* stream) {
  return launch<double>(q, qs, bptr, bstr, table, words, E, S, D, P, B, out,
                        stream);
}
