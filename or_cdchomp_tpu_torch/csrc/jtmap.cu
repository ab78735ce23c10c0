// The Jacobian-transpose map of a batched step in one launch: the spheres'
// workspace gradients (obstacle and self-collision) mapped onto the joints,
// G = sum_s J(s)^T w_s without a Jacobian, for total_cost_grad_batched
// (or_cdchomp_tpu_torch/chomp/cost_soa.py) on a CUDA tensor.
//
// No Pallas kernel is replaced: the JAX package computes this map in plain
// jnp (or_cdchomp_tpu/models/robot.py, CompiledFK.apply_sphere_jacT_soa)
// and XLA fuses it.  In eager PyTorch the same map is some 34 passes over
// (3 or 6, m, S, B) tensors in device memory (the sum of the two
// gradients, a cross product per component, a stack, flip / cumsum / flip,
// a zero cat, a row pick, then a cross, a sub and a dot over the DOFs),
// and a floating base adds its own cross, cat and sum: 2.84 of a 6.52 ms
// replayed step at B = 10,240, about 8% of the phase's byte bound.
//
// What bounds it on the H100: the loads.  Per (moving point, problem) the
// thread reads x, w_obs and w_self at its S spheres (9 S values) and the
// anchors and axes of its D joints (6 D), and writes D values of G (and 6
// per-point totals under a floating base): 177 read and 7 written for the
// WAM7 (S = 15, D = 7), 0.75 GB at 99 x 10,240 in float32 (0.22 ms at
// 3.35 TB/s).  The arithmetic, 18 operations a sphere and 17 a joint, is
// far below the card's rate.
//
// What the design does about it:
//  - One thread per (moving point, problem), the problem index fastest, so
//    each of the thread's loads is one coalesced line per warp in the
//    (c, m, K, B) layout K1, K2 and the FK kernel use; every input comes
//    through its four strides, so the anchors and axes are read as the
//    views fk_out.anch_pos[:, lo:lo + m] and fk_out.axis_w[:, lo:lo + m]
//    with no copy.  w = w_obs + w_self is formed in registers: the summed
//    gradient is never written.
//  - The DOF-affects-sphere structure is data: a small program of D + 1
//    steps and a sphere list (ops/jtmap.py pack_table), staged in shared
//    memory by each block (at most 48 KB; WAM7's is 55 words).  A step
//    optionally clears the six running sums (sum x x w, sum w), adds its
//    slice of the sphere list, then emits its DOF's row: a . (sum x x w -
//    o x sum w) for a revolute joint, a . sum w for a prismatic one.  The
//    last step's sums, over every sphere, are the floating base's
//    totals, written only when asked for.
//      * A serial chain (CompiledFK._jt_suffix): the list is the suffix
//        order walked from its end, the steps run from the last DOF to
//        the first and never clear, so each DOF's sums are its suffix's:
//        O(S + D) work a thread with six accumulators.
//      * A branching chain (CompiledFK._jt_mask): a step per DOF over the
//        spheres the mask gives it, each clearing first, then one over
//        every sphere for the totals.
//
// Numerics: the formulas of ops/soa.py in the same association (cross,
// sub, dot; built with -fmad=false, so no product is fused into a sum),
// in the step's dtype, with no TF32.  The sums over the spheres are taken
// in the list's order, the suffix walk's that of the plain version's
// flip / cumsum / flip (on the card the two read bit-equal in float32 and
// float64; PyTorch's CPU cumsum keeps a float32 sum in float64).  The
// plain versions are the step's PyTorch code on the CPU
// (cost_soa._jacT_plain: CompiledFK.apply_sphere_jacT_soa and the
// floating base's sums) and, reading the same table, ops/jtmap.py
// jtmap_table_ref.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStepWords = 5;   // ops/jtmap.py STEP_WORDS
constexpr int kRevolute = 1;    // models/robot.py REVOLUTE

// the five inputs x, w_obs, w_self (·=S), anchors, axes (·=D), each read
// at c s[0] + p s[1] + k s[2] + b s[3]
template <typename T>
struct Inputs {
  const T* ptr[5];
  int64_t st[5][4];
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    jtmap_kernel(Inputs<T> in, const int* __restrict__ table, int words,
                 int n_steps, int D, int m, int B, T* __restrict__ G,
                 T* __restrict__ tot) {
  extern __shared__ int tab[];
  for (int i = threadIdx.x; i < words; i += kThreads) tab[i] = table[i];
  __syncthreads();
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (int64_t)m * B) return;
  const int p = (int)(t / B);
  const int b = (int)(t - (int64_t)p * B);
  const T* __restrict__ at[5];
  for (int i = 0; i < 5; ++i)
    at[i] = in.ptr[i] + (int64_t)p * in.st[i][1] + (int64_t)b * in.st[i][3];
  const T* __restrict__ x = at[0];
  const T* __restrict__ wo = at[1];
  const T* __restrict__ ws = at[2];
  const int64_t xc = in.st[0][0], xk = in.st[0][2];
  const int64_t oc = in.st[1][0], ok = in.st[1][2];
  const int64_t sc = in.st[2][0], sk = in.st[2][2];
  const int* list = tab + kStepWords * (D + 1);

  T sx = T(0), sy = T(0), sz = T(0);   // sum x x w
  T wx = T(0), wy = T(0), wz = T(0);   // sum w
  for (int k = 0; k < n_steps; ++k) {
    const int* step = tab + k * kStepWords;
    if (step[0]) {
      sx = sy = sz = wx = wy = wz = T(0);
    }
    for (int i = step[1]; i < step[2]; ++i) {
      const int64_t s = list[i];
      const T px = x[s * xk], py = x[xc + s * xk], pz = x[2 * xc + s * xk];
      const T vx = wo[s * ok] + ws[s * sk];
      const T vy = wo[oc + s * ok] + ws[sc + s * sk];
      const T vz = wo[2 * oc + s * ok] + ws[2 * sc + s * sk];
      sx += py * vz - pz * vy;
      sy += pz * vx - px * vz;
      sz += px * vy - py * vx;
      wx += vx;
      wy += vy;
      wz += vz;
    }
    if (k == D) {   // the totals over every sphere: (6, m, B)
      const int64_t mb = (int64_t)m * B, pb = (int64_t)p * B + b;
      tot[pb] = sx;
      tot[mb + pb] = sy;
      tot[2 * mb + pb] = sz;
      tot[3 * mb + pb] = wx;
      tot[4 * mb + pb] = wy;
      tot[5 * mb + pb] = wz;
      break;
    }
    const int d = step[3];
    const T* a = at[4] + (int64_t)d * in.st[4][2];
    const int64_t ac = in.st[4][0];
    const T ax = a[0], ay = a[ac], az = a[2 * ac];
    T g;
    if (step[4] == kRevolute) {
      const T* o = at[3] + (int64_t)d * in.st[3][2];
      const int64_t c = in.st[3][0];
      const T ox = o[0], oy = o[c], oz = o[2 * c];
      g = ax * (sx - (oy * wz - oz * wy)) + ay * (sy - (oz * wx - ox * wz)) +
          az * (sz - (ox * wy - oy * wx));
    } else {   // prismatic
      g = ax * wx + ay * wy + az * wz;
    }
    G[((int64_t)p * D + d) * B + b] = g;
  }
}

template <typename T>
int launch(const void* const* ptrs, const int64_t* strides, const int* table,
           int words, int D, int m, int B, T* G, T* tot, void* stream) {
  const int64_t n = (int64_t)m * B;
  const int n_steps = D + (tot != nullptr ? 1 : 0);
  if (n == 0 || n_steps == 0) return 0;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  Inputs<T> in;
  for (int i = 0; i < 5; ++i) {
    in.ptr[i] = static_cast<const T*>(ptrs[i]);
    for (int j = 0; j < 4; ++j) in.st[i][j] = strides[4 * i + j];
  }
  // the table in shared memory: past 48 KB the launch itself fails
  jtmap_kernel<T><<<(unsigned)blocks, kThreads, (size_t)words * sizeof(int),
                    (cudaStream_t)stream>>>(in, table, words, n_steps, D, m,
                                            B, G, tot);
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs: x, w_obs, w_self (3, m, S, B), anchors, axes (3, m, D, B), each
// read through its 4 strides (strides[4 i .. 4 i + 3]); table: ops/jtmap.py
// pack_table's words (words of them) for D DOFs; G: (m, D, B) out; tot:
// (6, m, B) out, or null where the base is fixed.
extern "C" int cdx_jtmap(const void* const* ptrs, const int64_t* strides,
                         const int* table, int words, int D, int m, int B,
                         float* G, float* tot, void* stream) {
  return launch<float>(ptrs, strides, table, words, D, m, B, G, tot, stream);
}

extern "C" int cdx_jtmap_f64(const void* const* ptrs, const int64_t* strides,
                             const int* table, int words, int D, int m, int B,
                             double* G, double* tot, void* stream) {
  return launch<double>(ptrs, strides, table, words, D, m, B, G, tot, stream);
}
