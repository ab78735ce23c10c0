// Joint-limit repair of a problem batch, one block per problem, looping on
// the device until its row is clean.
//
// No Pallas kernel is replaced: the JAX package runs the repair as an XLA
// lax.while_loop (or_cdchomp_tpu/chomp/solver.py:400-431,
// ChompEngine._limit_repair_batched; chomp.c:608-655), so its solve never
// leaves the device.  Each round, per problem (T (m, n), limits lo, hi (n)):
//
//   Gj = where(T < lo, lo - T, 0) + where(T > hi, hi - T, 0)
//   a  = argmax |Gj| over the row-major flattened row (first index on ties)
//   if |Gj[a]| == 0: the row is clean, stop
//   GjA = A^-1 Gj,  scale = 1.01 Gj[a] / (GjA[a] == 0 ? 1 : GjA[a])
//   T += scale GjA
//
// at most max_rounds (1000) rounds.  JAX rounds while any row of the batch
// violates; a row that has stopped violating is kept by where(pred, ...) and
// never changes again, so "rounds while any row violates, capped at 1000" is
// "each row rounds until it is clean, capped at 1000": each block loops on
// its own, with no flag to the host.
//
// A^-1 Gj runs over the violating entries only: GjA[p, j] = sum over the
// rows i where Gj[i, j] != 0 of A^-1[p, i] Gj[i, j], in ascending i (the
// zeros add nothing).  Each round compacts the violations column by column
// into the block's slice of the scratch lists (idx, val), in order, with
// warp ballots, so the sums have a fixed order and the kernel is
// deterministic.  A^-1 is the dense metric's (m, m) matrix, read from global
// memory by row (39 KB at m = 99; up to 260 KB below the semiseparable
// switch, so not always in shared memory), or, with ainv null, the
// semiseparable metric's analytic entries dt^2 (min(p, q) + 1) (m - max(p, q))
// (or_cdchomp_tpu_torch/chomp/metric.py).
//
// Bound: T read and written once, 2 B m n sizeof(T) bytes (1.42 MB at
// config 1, 0.42 us at 3.35 TB/s), so the kernel is launch-bound; what it
// buys is the removed host sync per round, which lets a step be captured in
// a CUDA graph.  The plain version is or_cdchomp_tpu_torch/ops/limits.py
// (limit_repair_ref): the same arithmetic in the same association (built
// with -fmad=false), with A^-1 Gj as a matmul or two cumsums, so the two
// agree to the sums' rounding.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// the argmax order over (|g|, row-major index): NaN above everything, then
// the larger value, then the lower index (torch.argmax, jnp.argmax)
template <typename T>
__device__ __forceinline__ bool beats(T a, int ea, T b, int eb) {
  const bool na = a != a, nb = b != b;
  if (na || nb) return na && (!nb || ea < eb);
  return a > b || (a == b && ea < eb);
}

template <typename T>
__device__ __forceinline__ T violation(T t, T l, T h) {
  const T below = t < l ? l - t : T(0);
  const T above = t > h ? h - t : T(0);
  return below + above;
}

// A^-1[p, i]: the dense matrix's entry, or the semiseparable closed form
template <typename T>
__device__ __forceinline__ T ainv_at(const T* __restrict__ ainv, T dt2, int m,
                                     int p, int i) {
  if (ainv != nullptr) return ainv[(int64_t)p * m + i];
  const int lo = p < i ? p : i;
  const int hi = p < i ? i : p;
  return dt2 * T(lo + 1) * T(m - hi);
}

// GjA[p, j]: column j's violations (list entries [k0, k1)), ascending i
template <typename T>
__device__ __forceinline__ T gja_at(const T* __restrict__ ainv, T dt2, int m,
                                    int p, int j, int k0, int k1,
                                    const int* __restrict__ idx,
                                    const T* __restrict__ val) {
  T acc = T(0);
  for (int k = k0; k < k1; ++k)
    acc += ainv_at(ainv, dt2, m, p, idx[k] - j * m) * val[k];
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    limit_repair_kernel(const T* __restrict__ t_in, const T* __restrict__ lo,
                        const T* __restrict__ hi, const T* __restrict__ ainv,
                        T dt2, int m, int n, int max_rounds,
                        T* __restrict__ t_out, int* __restrict__ idx,
                        T* __restrict__ val, int* __restrict__ stats) {
  extern __shared__ int col_start[];   // n + 1 list offsets, by column
  __shared__ int warp_count[kWarps];
  __shared__ T best_a[kWarps];
  __shared__ int best_e[kWarps];
  __shared__ T s_scale;
  __shared__ int s_go;

  const int mn = m * n;
  const int64_t row = (int64_t)blockIdx.x * mn;
  const T* tin = t_in + row;
  T* tb = t_out + row;
  int* ib = idx + row;
  T* vb = val + row;
  const T* lb = lo + (int64_t)blockIdx.x * n;
  const T* hb = hi + (int64_t)blockIdx.x * n;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int e = threadIdx.x; e < mn; e += kThreads) tb[e] = tin[e];
  __syncthreads();

  int rounds = 0;
  long long entries = 0;
  for (; rounds < max_rounds; ++rounds) {
    // the violations in column order c = j m + i, compacted in that order;
    // each thread keeps its best (|g|, row-major index)
    T ba = T(0);
    int be = INT_MAX;
    int base = 0;
    for (int c0 = 0; c0 < mn; c0 += kThreads) {
      const int c = c0 + threadIdx.x;
      T g = T(0);
      if (c < mn) {
        const int j = c / m;
        const int i = c - j * m;
        const int e = i * n + j;
        g = violation(tb[e], lb[j], hb[j]);
        const T a = g < T(0) ? -g : g;
        if (beats(a, e, ba, be)) {
          ba = a;
          be = e;
        }
      }
      const bool nz = c < mn && g != T(0);
      const unsigned ballot = __ballot_sync(kFull, nz);
      if (lane == 0) warp_count[warp] = __popc(ballot);
      __syncthreads();
      int pos = base + __popc(ballot & ((1u << lane) - 1u));
      int total = 0;
      for (int w = 0; w < kWarps; ++w) {
        if (w < warp) pos += warp_count[w];
        total += warp_count[w];
      }
      if (c < mn && c % m == 0) col_start[c / m] = pos;
      if (nz) {
        ib[pos] = c;
        vb[pos] = g;
      }
      base += total;
      __syncthreads();   // warp_count is written again by the next chunk
    }

    for (int off = 16; off > 0; off >>= 1) {
      const T oa = __shfl_down_sync(kFull, ba, off);
      const int oe = __shfl_down_sync(kFull, be, off);
      if (beats(oa, oe, ba, be)) {
        ba = oa;
        be = oe;
      }
    }
    if (lane == 0) {
      best_a[warp] = ba;
      best_e[warp] = be;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      col_start[n] = base;
      T a = best_a[0];
      int e = best_e[0];
      for (int w = 1; w < kWarps; ++w)
        if (beats(best_a[w], best_e[w], a, e)) {
          a = best_a[w];
          e = best_e[w];
        }
      const int ai = e / n;
      const int aj = e - ai * n;
      const T gmax = violation(tb[e], lb[aj], hb[aj]);
      const bool go = (gmax < T(0) ? -gmax : gmax) > T(0);
      s_go = go;
      if (go) {
        // GjA at the argmax, by the same sum the update below takes there
        const T d = gja_at(ainv, dt2, m, ai, aj, col_start[aj],
                           col_start[aj + 1], ib, vb);
        s_scale = T(1.01) * gmax / (d == T(0) ? T(1) : d);
      }
    }
    __syncthreads();
    if (!s_go) break;
    entries += base;

    const T scale = s_scale;
    for (int c = threadIdx.x; c < mn; c += kThreads) {
      const int j = c / m;
      const int p = c - j * m;
      const T gja = gja_at(ainv, dt2, m, p, j, col_start[j],
                           col_start[j + 1], ib, vb);
      const int e = p * n + j;
      tb[e] = tb[e] + scale * gja;
    }
    __syncthreads();   // the next round reads every entry of the row
  }
  if (stats != nullptr && threadIdx.x == 0) {
    stats[2 * blockIdx.x] = rounds;
    stats[2 * blockIdx.x + 1] =
        entries > (long long)INT_MAX ? INT_MAX : (int)entries;
  }
}

template <typename T>
int launch(const T* t_in, const T* lo, const T* hi, const T* ainv, double dt2,
           int B, int m, int n, int max_rounds, T* t_out, int* idx, T* val,
           int* stats, void* stream) {
  if (B == 0 || m == 0 || n == 0) return 0;
  const size_t smem = (size_t)(n + 1) * sizeof(int);
  limit_repair_kernel<T><<<B, kThreads, smem, (cudaStream_t)stream>>>(
      t_in, lo, hi, ainv, (T)dt2, m, n, max_rounds, t_out, idx, val, stats);
  return (int)cudaGetLastError();
}

}  // namespace

// T (B, m, n) in, T' out; lo, hi (B, n); ainv (m, m) or null for the
// semiseparable metric of step dt (dt2 = dt * dt); idx, val (B, m n)
// scratch; stats, when not null, receives per problem (rounds applied,
// list entries summed over them), (B, 2) int32.
extern "C" int cdx_limit_repair(const float* t_in, const float* lo,
                                const float* hi, const float* ainv, double dt2,
                                int B, int m, int n, int max_rounds,
                                float* t_out, int* idx, float* val,
                                int* stats, void* stream) {
  return launch<float>(t_in, lo, hi, ainv, dt2, B, m, n, max_rounds, t_out,
                       idx, val, stats, stream);
}

extern "C" int cdx_limit_repair_f64(const double* t_in, const double* lo,
                                    const double* hi, const double* ainv,
                                    double dt2, int B, int m, int n,
                                    int max_rounds, double* t_out, int* idx,
                                    double* val, int* stats, void* stream) {
  return launch<double>(t_in, lo, hi, ainv, dt2, B, m, n, max_rounds, t_out,
                        idx, val, stats, stream);
}
