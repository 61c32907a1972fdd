// FCT-ALE kernels for Hopper (sm_90a), templated on float/double, with
// extern "C" launchers that are loaded through ctypes (ops/cuda/build.py,
// ops/cuda/kernels.py):
//   * the single-device chain K1 bounds -> K2 limit -> K34 update_fused,
//     or any of its other forms: K12 limit_fused (K1 and K2 in one pass)
//     in place of K1 -> K2, and K3 -> K4 in place of K34;
//   * the split chain of a sharded step, K1 -> K2 -> K3 b3h -> halo
//     exchange -> K3fix b3h_fixup -> K4 update: K3 limits every edge on the
//     pre-exchange factors, K3fix redoes the edges that touch a halo node
//     with the exchanged ones, K4 is stage c from the limited edge fluxes;
//   * A2 a2, the standalone element bounds of the tuning harness.
//
// Each kernel computes what the JAX package's Pallas kernel of the same
// role computes, on natural level-major shapes: node fields [L, N],
// interface fields [L+1, N], edge fields [L, Ed], element fields [L, E].
// None of the TPU layout machinery carries over (one-hot MXU contractions,
// DIA lane rolls, packed home slots, DMA windows, 128-lane tiles): all of it
// stands in for the vector gather that Hopper has.
//
// Design shared by the node kernels (K1, K2, K12, K34, K4):
//   * one thread per node, looping over the levels z; consecutive threads
//     read consecutive nodes at each level, so node-field accesses are
//     coalesced and the [L, N] layout stays the API layout;
//   * the node's incidence row (up to MAXD slots of nd_idx / nd_other /
//     nd_lev / nd_sgn / nd_wrt) is loaded once into registers;
//   * vertical stencils (a3's z-1..z+1 window, b3v's z-1 factors, stage c's
//     z+1 interface) are carried in registers across the level loop;
//   * every edge->node sum is a gather over the node's incident edges, and
//     each edge output of K34 is written once, from the one incidence slot
//     that nd_wrt marks (ops/meshdata.py): no atomics, so results are
//     identical from run to run.
// The edge and element kernels (K3, K3fix, A2) run one thread per (edge or
// element, level), consecutive threads on consecutive entities of one
// level.  All are bound by device-memory traffic (a few flops per byte);
// the neighbour gathers at each level hit L2/L1 because the mesh numbering
// keeps neighbours within about min(nx, ny) node indices.
//
// Launch configuration: every launcher takes the threads per block (64,
// 128, 256 or 512; 128 is the default the wrappers pass) and every kernel
// is instantiated once per block size with __launch_bounds__ of that size
// (min_blocks below), so the 128-thread instances compile exactly as they
// did with a fixed block of 128, and a larger block gets a register cap
// that fits it.  The
// node kernels' 16-slot instances (meshes of node degree > 8) exist for
// 64 and 128 threads only: at 256 or 512 their registers would spill.  The
// tuning harness (utils/tuning.py) sweeps this, as the JAX harness sweeps
// the Pallas tile and chunk sizes.
//
// Built without --use_fast_math: b2's divisions and every limiter
// selection stay IEEE.  nvcc still contracts a*b+c into FMA, one reason
// (with the order of the incident-edge sums) that K2, K12, K34 and K4 agree
// with their plain versions to a relative error and not bit for bit.  K1
// and A2 do only max/min, selects and one subtraction, and K3/K3fix only
// selects and one product per output, so those are bit-exact.

#include <cuda_runtime.h>
#include <cstddef>
#include <type_traits>

namespace {

// The least resident blocks per SM hinted to ptxas: none (0) below 512
// threads, so those instances compile exactly as with a bare
// __launch_bounds__(THREADS); one at 512, which lets a 512-thread block use
// up to 128 registers a thread (without it ptxas held limit_kernel<double,
// 8, 512> to 64 registers and spilled).
constexpr int min_blocks(int threads) { return threads >= 512 ? 1 : 0; }

__device__ __forceinline__ float vmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double vmax(double a, double b) { return fmax(a, b); }
__device__ __forceinline__ float vmin(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double vmin(double a, double b) { return fmin(a, b); }

// ---------------------------------------------------------------------------
// H-K1 bounds.  Replaces kernels.py:bounds_dia_dma_pallas (with the
// computation of _dia_bounds_vals and _bounds_epilogue_vals): a1 on the
// node, the element-cluster max/min as a max/min over the node and its
// edge-neighbours m, where m takes part at level z iff z < nlev_edge(n, m)
// (stages._cluster_reduce_via_edges, used for every vlimit), then the
// vlimit 1/2/3 vertical window and "- fct_LO" on active rows.
// ---------------------------------------------------------------------------

template <typename T>
struct Level {
  T cmax, cmin;  // cluster bounds at this level
  T a1max;       // a1's masked fct_ttf_max at the node (vlimit 2/3 window)
  T lo;          // fct_LO at the node
};

template <typename T, int MAXD>
__device__ __forceinline__ Level<T> cluster_level(
    const T* __restrict__ lo, const T* __restrict__ ttf, int z, int n,
    int N, int nlev, const int (&oth)[MAXD], const int (&lev)[MAXD]) {
  const T big = T(1e30);
  const size_t row = (size_t)z * N;
  const T l = lo[row + n];
  const T t = ttf[row + n];
  const bool act = z < nlev - 1;
  Level<T> r;
  r.lo = l;
  r.a1max = act ? vmax(l, t) : T(0);
  r.cmax = act ? vmax(l, t) : -big;
  r.cmin = act ? vmin(l, t) : big;
#pragma unroll
  for (int k = 0; k < MAXD; ++k) {
    // lev[k] is 0 on padding slots; a live edge's level bound never
    // exceeds either endpoint's active layers, so the neighbour's a1 needs
    // no mask of its own
    if (z < lev[k]) {
      const T a = lo[row + oth[k]];
      const T b = ttf[row + oth[k]];
      r.cmax = vmax(r.cmax, vmax(a, b));
      r.cmin = vmin(r.cmin, vmin(a, b));
    }
  }
  return r;
}

// The vertical window of K1 carried across the level loop: the cluster
// bounds and a1 at levels z-1 (padded at the surface), z and z+1.
template <typename T>
struct Window {
  T pmax, pmin;    // cluster bounds at z-1
  T pa_hi, pa_lo;  // a1max at z-1 (max / min window pads)
  Level<T> cur;    // level z
};

template <typename T, int MAXD>
__device__ __forceinline__ Window<T> window_start(
    const T* __restrict__ lo, const T* __restrict__ ttf, int n, int N,
    int nlev, const int (&oth)[MAXD], const int (&lev)[MAXD]) {
  const T big = T(1e30);
  Window<T> w;
  w.pmax = -big;
  w.pmin = big;
  w.pa_hi = -big;
  w.pa_lo = big;
  w.cur = cluster_level<T, MAXD>(lo, ttf, 0, n, N, nlev, oth, lev);
  return w;
}

// K1 at level z of node n: fct_ttf_max / fct_ttf_min (0 on inactive rows)
// into tx / tn, then the window moved down to z+1.  Shared by K1 and K12,
// so both compute the same bits.
template <typename T, int MAXD>
__device__ __forceinline__ void bounds_level(
    const T* __restrict__ lo, const T* __restrict__ ttf, int z, int n,
    int L, int N, int nlev, int vlimit, const int (&oth)[MAXD],
    const int (&lev)[MAXD], Window<T>& w, T& tx, T& tn) {
  const T big = T(1e30);
  Level<T> nxt;
  T na_hi, na_lo;
  if (z + 1 < L) {
    nxt = cluster_level<T, MAXD>(lo, ttf, z + 1, n, N, nlev, oth, lev);
    na_hi = nxt.a1max;
    na_lo = nxt.a1max;
  } else {
    nxt.cmax = -big;
    nxt.cmin = big;
    nxt.a1max = T(0);
    nxt.lo = T(0);
    na_hi = -big;
    na_lo = big;
  }
  const Level<T>& cur = w.cur;
  const bool act = z < nlev - 1;
  const bool plain = (z == 0) || (z >= nlev - 2);
  T smax = cur.cmax, smin = cur.cmin;
  if (!plain) {
    if (vlimit == 1) {
      smax = vmax(vmax(w.pmax, cur.cmax), nxt.cmax);
      smin = vmin(vmin(w.pmin, cur.cmin), nxt.cmin);
    } else {
      // vlimit 2/3: both windows over a1's fct_ttf_max
      const T wmax = vmax(vmax(w.pa_hi, cur.a1max), na_hi);
      const T wmin = vmin(vmin(w.pa_lo, cur.a1max), na_lo);
      if (vlimit == 2) {
        smax = vmax(cur.cmax, wmax);
        smin = vmin(cur.cmin, wmin);
      } else {
        smax = vmin(cur.cmax, wmax);
        smin = vmax(cur.cmin, wmin);
      }
    }
  }
  tx = act ? smax - cur.lo : T(0);
  tn = act ? smin - cur.lo : T(0);
  w.pmax = cur.cmax;
  w.pmin = cur.cmin;
  w.pa_hi = cur.a1max;
  w.pa_lo = cur.a1max;
  w.cur = nxt;
}

template <typename T, int MAXD, int THREADS>
__global__ void __launch_bounds__(THREADS, min_blocks(THREADS))
bounds_kernel(const T* __restrict__ lo, const T* __restrict__ ttf,
              const int* __restrict__ nd_other,
              const int* __restrict__ nd_lev,
              const int* __restrict__ nd_num,
              const int* __restrict__ nlev_nod, T* __restrict__ tmax_out,
              T* __restrict__ tmin_out, int L, int N, int KD, int vlimit) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int nlev = nlev_nod[n];
  const int num = nd_num[n];
  int oth[MAXD], lev[MAXD];
#pragma unroll
  for (int k = 0; k < MAXD; ++k) {
    const bool ok = k < num;
    oth[k] = ok ? nd_other[(size_t)n * KD + k] : n;
    lev[k] = ok ? nd_lev[(size_t)n * KD + k] : 0;
  }
  Window<T> w = window_start<T, MAXD>(lo, ttf, n, N, nlev, oth, lev);
  for (int z = 0; z < L; ++z) {
    T tx, tn;
    bounds_level<T, MAXD>(lo, ttf, z, n, L, N, nlev, vlimit, oth, lev, w,
                          tx, tn);
    const size_t idx = (size_t)z * N + n;
    tmax_out[idx] = tx;
    tmin_out[idx] = tn;
  }
}

// ---------------------------------------------------------------------------
// H-K2 limit.  Replaces kernels_packed.py:limit_packed_pallas (the
// computation of _limit_body): b1 vertical, the b1 horizontal signed +/-
// sums over incident edges (masked by z < nlev_edge), the b2 Zalesak
// factors and b3 vertical.  b3v limits row z iff z < nlev_nod - 1, as
// stages.b3_vertical and the numpy oracle do; the bottom interface row L
// passes through.
// ---------------------------------------------------------------------------

// The node's bounds at one level, as K2 reads them (from device memory,
// where b2 uses them, as the parent kernel did) and as K12 holds them (in
// registers).
template <typename T>
struct BoundsInMemory {
  const T* __restrict__ tmax;
  const T* __restrict__ tmin;
  size_t idx;
  __device__ __forceinline__ T max() const { return tmax[idx]; }
  __device__ __forceinline__ T min() const { return tmin[idx]; }
};

template <typename T>
struct BoundsInRegisters {
  T tx, tn;
  __device__ __forceinline__ T max() const { return tx; }
  __device__ __forceinline__ T min() const { return tn; }
};

// Whether incidence slot k is the edge's first endpoint: K2 keeps one flag
// per slot (as K34 and K4 do), K12 one bit per slot, to save registers.
template <int MAXD>
__device__ __forceinline__ bool is_first(const bool (&first)[MAXD], int k) {
  return first[k];
}
__device__ __forceinline__ bool is_first(unsigned first, int k) {
  return (first >> k) & 1u;
}

// K2 at level z of node n, from the bounds of that node and level (read
// only on active rows) and the vertical fluxes up (interface z) and dn
// (interface z+1); the b3v factors of level z-1 are carried in fp_prev /
// fm_prev.  Shared by K2 and K12, so both compute the same bits.
template <typename T, int MAXD, typename First, typename Bounds>
__device__ __forceinline__ void limit_level(
    const T* __restrict__ adf_h, const T* __restrict__ area_inv,
    const int (&eidx)[MAXD], const int (&lev)[MAXD], const First& first,
    int z, size_t idx, int Ed, bool act, const Bounds& bnd, T up, T dn,
    T dt, T eps, T& fp_prev, T& fm_prev, T* __restrict__ plus_out,
    T* __restrict__ minus_out, T* __restrict__ adf_v_lim,
    T* __restrict__ adf_v_res) {
  // b1 vertical (kernels/fct_ale_b1_vertical.cu:13-14)
  const T pv = vmax(T(0), up) + vmax(T(0), -dn);
  const T mv = vmin(T(0), up) + vmin(T(0), -dn);
  // b1 horizontal: signed incident-edge fluxes
  T gp = T(0), gm = T(0);
  const size_t erow = (size_t)z * Ed;
#pragma unroll
  for (int k = 0; k < MAXD; ++k) {
    if (z < lev[k]) {
      const T f = adf_h[erow + eidx[k]];
      const T x = is_first(first, k) ? f : -f;
      gp += vmax(T(0), x);
      gm += vmin(T(0), x);
    }
  }
  // b2 (kernels/fct_ale_b2.cu:10-11)
  const T ai = area_inv[idx];
  const T fplus = (pv + gp) * dt * ai + eps;
  const T fminus = (mv + gm) * dt * ai - eps;
  const T fp = act ? vmin(T(1), bnd.max() / fplus) : T(0);
  const T fm = act ? vmin(T(1), bnd.min() / fminus) : T(0);
  plus_out[idx] = fp;
  minus_out[idx] = fm;
  // b3 vertical (kernels/fct_ale_b3_vertical.cu:17-45)
  const T flux = up;
  const T ae_pos = vmin(T(1), vmin(fm_prev, fp));
  const T ae_neg = vmin(T(1), vmin(fp_prev, fm));
  const T ae = flux >= T(0) ? ae_pos : ae_neg;
  adf_v_lim[idx] = act ? ae * flux : flux;
  if (adf_v_res != nullptr) {
    adf_v_res[idx] = (act && z >= 1) ? (T(1) - ae) * flux : T(0);
  }
  fp_prev = fp;
  fm_prev = fm;
}

template <typename T, int MAXD, int THREADS>
__global__ void __launch_bounds__(THREADS, min_blocks(THREADS))
limit_kernel(const T* __restrict__ adf_v, const T* __restrict__ tmax,
             const T* __restrict__ tmin, const T* __restrict__ adf_h,
             const T* __restrict__ area_inv, const int* __restrict__ nd_idx,
             const int* __restrict__ nd_lev,
             const signed char* __restrict__ nd_sgn,
             const int* __restrict__ nd_num,
             const int* __restrict__ nlev_nod, T* __restrict__ plus_out,
             T* __restrict__ minus_out, T* __restrict__ adf_v_lim,
             T* __restrict__ adf_v_res, int L, int N, int Ed, int KD, T dt,
             T eps) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int nlev = nlev_nod[n];
  const int num = nd_num[n];
  int eidx[MAXD], lev[MAXD];
  bool first[MAXD];
#pragma unroll
  for (int k = 0; k < MAXD; ++k) {
    const bool ok = k < num;
    eidx[k] = ok ? nd_idx[(size_t)n * KD + k] : 0;
    lev[k] = ok ? nd_lev[(size_t)n * KD + k] : 0;
    first[k] = ok && nd_sgn[(size_t)n * KD + k] > 0;
  }

  T fp_prev = T(1), fm_prev = T(1);  // b3v factors at z-1 (1 above z=0)
  T up = adf_v[n];
  for (int z = 0; z < L; ++z) {
    const size_t idx = (size_t)z * N + n;
    const T dn = adf_v[idx + N];
    limit_level<T, MAXD>(adf_h, area_inv, eidx, lev, first, z, idx, Ed,
                         z < nlev - 1, BoundsInMemory<T>{tmax, tmin, idx}, up,
                         dn, dt, eps, fp_prev, fm_prev, plus_out, minus_out,
                         adf_v_lim, adf_v_res);
    up = dn;
  }
  const size_t last = (size_t)L * N + n;
  adf_v_lim[last] = up;
  if (adf_v_res != nullptr) adf_v_res[last] = T(0);
}

// ---------------------------------------------------------------------------
// H-K12 limit_fused.  Replaces kernels_packed.py:limit_fused_pallas (the
// computation of _limit_fused_kernel): K1 and K2 in one level loop of one
// thread per node.  At each z the K1 window gives the node's bounds
// (bounds_level), which are written out and fed, as values, to K2's body
// at the same z (limit_level): b2 needs the bounds of its own node and
// level only, and the a3 window's z+1 look-ahead is already carried in
// registers, so the fusion recomputes nothing.  It saves the write and
// re-read of fct_ttf_max/min through device memory (the bounds are still
// written once, as outputs of the step) and one launch.  b3v follows the
// oracle's mask z < nlev_nod - 1, as K2 does; the Pallas kernel calls
// _limit_body, whose mask is z < nlev_nod (ROADMAP Queue C).
// Bound by memory traffic.  Registers are the risk: the thread holds both
// kernels' incidence rows (nd_other and nd_idx, with nd_lev loaded once
// for both and the first-endpoint flags in one bit mask), K1's three-level
// window and K2's carried b3v factors.
// ---------------------------------------------------------------------------

template <typename T, int MAXD, int THREADS>
__global__ void __launch_bounds__(THREADS, min_blocks(THREADS))
limit_fused_kernel(const T* __restrict__ lo, const T* __restrict__ ttf,
                   const T* __restrict__ adf_v, const T* __restrict__ adf_h,
                   const T* __restrict__ area_inv,
                   const int* __restrict__ nd_idx,
                   const int* __restrict__ nd_other,
                   const int* __restrict__ nd_lev,
                   const signed char* __restrict__ nd_sgn,
                   const int* __restrict__ nd_num,
                   const int* __restrict__ nlev_nod,
                   T* __restrict__ tmax_out, T* __restrict__ tmin_out,
                   T* __restrict__ plus_out, T* __restrict__ minus_out,
                   T* __restrict__ adf_v_lim, T* __restrict__ adf_v_res,
                   int L, int N, int Ed, int KD, int vlimit, T dt, T eps) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int nlev = nlev_nod[n];
  const int num = nd_num[n];
  int oth[MAXD], eidx[MAXD], lev[MAXD];
  unsigned first = 0u;
#pragma unroll
  for (int k = 0; k < MAXD; ++k) {
    const bool ok = k < num;
    oth[k] = ok ? nd_other[(size_t)n * KD + k] : n;
    eidx[k] = ok ? nd_idx[(size_t)n * KD + k] : 0;
    lev[k] = ok ? nd_lev[(size_t)n * KD + k] : 0;
    if (ok && nd_sgn[(size_t)n * KD + k] > 0) first |= 1u << k;
  }

  Window<T> w = window_start<T, MAXD>(lo, ttf, n, N, nlev, oth, lev);
  T fp_prev = T(1), fm_prev = T(1);
  T up = adf_v[n];
  for (int z = 0; z < L; ++z) {
    const size_t idx = (size_t)z * N + n;
    T tx, tn;
    bounds_level<T, MAXD>(lo, ttf, z, n, L, N, nlev, vlimit, oth, lev, w,
                          tx, tn);
    tmax_out[idx] = tx;
    tmin_out[idx] = tn;
    const T dn = adf_v[idx + N];
    limit_level<T, MAXD>(adf_h, area_inv, eidx, lev, first, z, idx, Ed,
                         z < nlev - 1, BoundsInRegisters<T>{tx, tn}, up, dn,
                         dt, eps, fp_prev, fm_prev, plus_out, minus_out,
                         adf_v_lim, adf_v_res);
    up = dn;
  }
  const size_t last = (size_t)L * N + n;
  adf_v_lim[last] = up;
  if (adf_v_res != nullptr) adf_v_res[last] = T(0);
}

// ---------------------------------------------------------------------------
// Stage c (docs/refactoring.md:269-314) at node idx, from the signed sum acc
// of its limited incident edge fluxes and its limited vertical fluxes up
// (interface z) and dn (interface z+1).  Shared by K34 and K4.
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ void stage_c(
    const T* __restrict__ ttf, const T* __restrict__ hnode,
    const T* __restrict__ hnode_new, const T* __restrict__ lo,
    const T* __restrict__ dvin, const T* __restrict__ dhin,
    const T* __restrict__ area_inv, T* __restrict__ o1, T* __restrict__ o2,
    size_t idx, bool act, T up, T dn, T acc, T dt, int iter_yn) {
  const T ai = area_inv[idx];
  const T ddiv = (up - dn) * dt * ai;
  const T dh = acc * dt * ai;
  const T l = lo[idx];
  if (iter_yn) {
    const T hnn = hnode_new[idx];
    o1[idx] = (act ? l + ddiv / hnn : l) + dh / hnn;
  } else {
    const T dv = -ttf[idx] * hnode[idx] + l * hnode_new[idx] + ddiv;
    const T d = dvin[idx];
    o1[idx] = act ? d + dv : d;
    o2[idx] = dhin[idx] + dh;
  }
}

// ---------------------------------------------------------------------------
// H-K34 update_fused.  Replaces kernels_packed.py:update_fused_pallas (the
// computation of _update_fused_kernel): for each incident edge, b3
// horizontal limiting from both endpoints' factors
// (kernels/fct_ale_b3_horizontal.cu:28-39), the signed sum of the limited
// fluxes into the node's stage-c increment (c_update_solution /
// c_update_LO), and stage c itself.  Each limited edge flux (and its
// residual) is written at every level from the one slot that nd_wrt marks:
// the edge's first endpoint on a whole mesh (the analogue of the packed
// layout's home slot), its owned second endpoint where the first is a halo
// node of a part, whose incidence row is empty.  The first n_free threads
// also pass the edges of ed_free through (a part's padding, in no row), so
// every edge output is written exactly once.
// ---------------------------------------------------------------------------

template <typename T, int MAXD, int THREADS>
__global__ void __launch_bounds__(THREADS, min_blocks(THREADS))
update_fused_kernel(const T* __restrict__ plus, const T* __restrict__ minus,
                    const T* __restrict__ adf_v_lim,
                    const T* __restrict__ adf_h, const T* __restrict__ ttf,
                    const T* __restrict__ hnode,
                    const T* __restrict__ hnode_new,
                    const T* __restrict__ lo, const T* __restrict__ dvin,
                    const T* __restrict__ dhin,
                    const T* __restrict__ area_inv,
                    const int* __restrict__ nd_idx,
                    const int* __restrict__ nd_other,
                    const int* __restrict__ nd_lev,
                    const signed char* __restrict__ nd_sgn,
                    const signed char* __restrict__ nd_wrt,
                    const int* __restrict__ nd_num,
                    const int* __restrict__ nlev_nod,
                    const int* __restrict__ ed_free, T* __restrict__ o1,
                    T* __restrict__ o2, T* __restrict__ adf_h_lim,
                    T* __restrict__ adf_h_res, int L, int N, int Ed, int KD,
                    int n_free, T dt, int iter_yn) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n < n_free) {
    const int e = ed_free[n];
    for (int z = 0; z < L; ++z) {
      const size_t idx = (size_t)z * Ed + e;
      adf_h_lim[idx] = adf_h[idx];
      if (adf_h_res != nullptr) adf_h_res[idx] = T(0);
    }
  }
  if (n >= N) return;
  const int nlev = nlev_nod[n];
  const int num = nd_num[n];
  int eidx[MAXD], oth[MAXD], lev[MAXD];
  bool live[MAXD], first[MAXD], wrt[MAXD];
#pragma unroll
  for (int k = 0; k < MAXD; ++k) {
    const bool ok = k < num;
    live[k] = ok;
    eidx[k] = ok ? nd_idx[(size_t)n * KD + k] : 0;
    oth[k] = ok ? nd_other[(size_t)n * KD + k] : n;
    lev[k] = ok ? nd_lev[(size_t)n * KD + k] : 0;
    first[k] = ok && nd_sgn[(size_t)n * KD + k] > 0;
    wrt[k] = ok && nd_wrt[(size_t)n * KD + k] != 0;
  }

  T up = adf_v_lim[n];
  for (int z = 0; z < L; ++z) {
    const size_t row = (size_t)z * N;
    const size_t idx = row + n;
    const size_t erow = (size_t)z * Ed;
    const T pn = plus[idx];
    const T mn = minus[idx];
    T acc = T(0);
#pragma unroll
    for (int k = 0; k < MAXD; ++k) {
      if (!live[k]) continue;
      const bool eact = z < lev[k];
      if (eact) {
        const T f = adf_h[erow + eidx[k]];
        const T po = plus[row + oth[k]];
        const T mo = minus[row + oth[k]];
        const T p1 = first[k] ? pn : po;
        const T m1 = first[k] ? mn : mo;
        const T p2 = first[k] ? po : pn;
        const T m2 = first[k] ? mo : mn;
        const T ae_pos = vmin(T(1), vmin(p1, m2));
        const T ae_neg = vmin(T(1), vmin(m1, p2));
        const T ae = f >= T(0) ? ae_pos : ae_neg;
        const T lim = ae * f;
        acc += first[k] ? lim : -lim;
        if (wrt[k]) {
          adf_h_lim[erow + eidx[k]] = lim;
          if (adf_h_res != nullptr) adf_h_res[erow + eidx[k]] = (T(1) - ae) * f;
        }
      } else if (wrt[k]) {
        // inactive level of this edge: the flux passes through unlimited
        adf_h_lim[erow + eidx[k]] = adf_h[erow + eidx[k]];
        if (adf_h_res != nullptr) adf_h_res[erow + eidx[k]] = T(0);
      }
    }
    const T dn = adf_v_lim[idx + N];
    stage_c(ttf, hnode, hnode_new, lo, dvin, dhin, area_inv, o1, o2, idx,
            z < nlev - 1, up, dn, acc, dt, iter_yn);
    up = dn;
  }
}

// ---------------------------------------------------------------------------
// H-K3 b3h and H-K3fix b3h_fixup.  Replace kernels_packed.py:
// b3h_packed_pallas / kernels.py:b3h_pallas (the split K3) and
// kernels_packed.py:b3h_packed_fixup_pallas / kernels.py:b3h_fixup_pallas
// (its post-exchange fixup): the limiter selection of
// kernels_packed.py:337-344 for one edge e = (n1, n2) at one level z,
//   ae = min(1, min(p1, m2)) if f >= 0 else min(1, min(m1, p2)),
// the limited flux ae * f and the residual (1 - ae) * f on active levels
// (z < nlev_edge), f and 0 elsewhere.  K3 covers every edge; K3fix only the
// edges of an id list (those that touch a halo node), writing in place
// into K3's outputs.  A duplicated id rewrites the same values.  Where the
// TPU kernels gather both endpoints' factors through one-hot contractions
// or packed pair shifts, each thread here reads them directly; the reads
// of one level fall within a few node rows of each other.
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ void b3h_edge(
    const T* __restrict__ plus, const T* __restrict__ minus,
    const T* __restrict__ adf_h, const int* __restrict__ edges,
    const int* __restrict__ nlev_edge, T* __restrict__ adf_h_lim,
    T* __restrict__ adf_h_res, int z, int e, int N, int Ed) {
  const size_t idx = (size_t)z * Ed + e;
  const T f = adf_h[idx];
  if (z < nlev_edge[e]) {
    const size_t row = (size_t)z * N;
    const int n1 = edges[2 * (size_t)e];
    const int n2 = edges[2 * (size_t)e + 1];
    const T ae_pos = vmin(T(1), vmin(plus[row + n1], minus[row + n2]));
    const T ae_neg = vmin(T(1), vmin(minus[row + n1], plus[row + n2]));
    const T ae = f >= T(0) ? ae_pos : ae_neg;
    adf_h_lim[idx] = ae * f;
    if (adf_h_res != nullptr) adf_h_res[idx] = (T(1) - ae) * f;
  } else {
    adf_h_lim[idx] = f;
    if (adf_h_res != nullptr) adf_h_res[idx] = T(0);
  }
}

template <typename T, int THREADS>
__global__ void __launch_bounds__(THREADS, min_blocks(THREADS))
b3h_kernel(const T* __restrict__ plus, const T* __restrict__ minus,
           const T* __restrict__ adf_h, const int* __restrict__ edges,
           const int* __restrict__ nlev_edge, T* __restrict__ adf_h_lim,
           T* __restrict__ adf_h_res, int N, int Ed) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= Ed) return;
  b3h_edge(plus, minus, adf_h, edges, nlev_edge, adf_h_lim, adf_h_res,
           (int)blockIdx.y, e, N, Ed);
}

template <typename T, int THREADS>
__global__ void __launch_bounds__(THREADS, min_blocks(THREADS))
b3h_fixup_kernel(const T* __restrict__ plus, const T* __restrict__ minus,
                 const T* __restrict__ adf_h, const int* __restrict__ edges,
                 const int* __restrict__ nlev_edge,
                 const int* __restrict__ ids, T* __restrict__ adf_h_lim,
                 T* __restrict__ adf_h_res, int N, int Ed, int n_ids) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_ids) return;
  const int e = ids[i];
  // ids come from the part's own edges (step_sharded.fix_edge_ids); an id
  // out of range must still not write outside the edge arrays
  if (e < 0 || e >= Ed) return;
  b3h_edge(plus, minus, adf_h, edges, nlev_edge, adf_h_lim, adf_h_res,
           (int)blockIdx.y, e, N, Ed);
}

// ---------------------------------------------------------------------------
// H-K4 update.  Replaces kernels_packed.py:update_packed_pallas and
// kernels.py:update_pallas (the split K4): stage c from edge fluxes that
// are already limited.  K34's node gather and epilogue without the
// limiting: the signed sum of the limited fluxes over the node's incidence
// slots in slot order, then stage_c.  It reads one edge value per slot and
// level where K34 reads the flux and the other endpoint's two factors.
// ---------------------------------------------------------------------------

template <typename T, int MAXD, int THREADS>
__global__ void __launch_bounds__(THREADS, min_blocks(THREADS))
update_kernel(const T* __restrict__ adf_v_lim,
              const T* __restrict__ adf_h_lim, const T* __restrict__ ttf,
              const T* __restrict__ hnode, const T* __restrict__ hnode_new,
              const T* __restrict__ lo, const T* __restrict__ dvin,
              const T* __restrict__ dhin, const T* __restrict__ area_inv,
              const int* __restrict__ nd_idx, const int* __restrict__ nd_lev,
              const signed char* __restrict__ nd_sgn,
              const int* __restrict__ nd_num,
              const int* __restrict__ nlev_nod, T* __restrict__ o1,
              T* __restrict__ o2, int L, int N, int Ed, int KD, T dt,
              int iter_yn) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int nlev = nlev_nod[n];
  const int num = nd_num[n];
  int eidx[MAXD], lev[MAXD];
  bool first[MAXD];
#pragma unroll
  for (int k = 0; k < MAXD; ++k) {
    const bool ok = k < num;
    eidx[k] = ok ? nd_idx[(size_t)n * KD + k] : 0;
    lev[k] = ok ? nd_lev[(size_t)n * KD + k] : 0;
    first[k] = ok && nd_sgn[(size_t)n * KD + k] > 0;
  }

  T up = adf_v_lim[n];
  for (int z = 0; z < L; ++z) {
    const size_t idx = (size_t)z * N + n;
    const size_t erow = (size_t)z * Ed;
    T acc = T(0);
#pragma unroll
    for (int k = 0; k < MAXD; ++k) {
      // lev[k] is 0 on padding slots
      if (z < lev[k]) {
        const T f = adf_h_lim[erow + eidx[k]];
        acc += first[k] ? f : -f;
      }
    }
    const T dn = adf_v_lim[idx + N];
    stage_c(ttf, hnode, hnode_new, lo, dvin, dhin, area_inv, o1, o2, idx,
            z < nlev - 1, up, dn, acc, dt, iter_yn);
    up = dn;
  }
}

// ---------------------------------------------------------------------------
// H-A2 a2.  Replaces kernels.py:a2_pallas (the computation of _a2_kernel):
// the element bounds of stage a2 (reference src/reference.cpp:321-351,
// stages.a2), UV_max / UV_min [L, E] = the max / min of a1's fct_ttf_max /
// fct_ttf_min over the element's 3 nodes where z < nlev_elem - 1, and
// -bignumber / +bignumber elsewhere (full-depth padding).  The Pallas
// kernel gathers the 3 nodes with a windowed one-hot MXU contraction; here
// one thread per (element, level), consecutive threads on consecutive
// elements of one level, reads the 3 nodes directly, so the [L, E] writes
// coalesce and the node reads of a warp fall within a few rows of the
// level (element ids follow node ids).  Bound by memory traffic: it writes
// two element fields and reads two node fields.  Max/min and selects only:
// bit-exact against its plain version.
// ---------------------------------------------------------------------------

template <typename T, int THREADS>
__global__ void __launch_bounds__(THREADS, min_blocks(THREADS))
a2_kernel(const T* __restrict__ tmax, const T* __restrict__ tmin,
          const int* __restrict__ elem_nodes,
          const int* __restrict__ nlev_elem, T* __restrict__ uv_max,
          T* __restrict__ uv_min, int N, int E, T big) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  const int z = (int)blockIdx.y;
  const size_t idx = (size_t)z * E + e;
  if (z < nlev_elem[e] - 1) {
    const size_t row = (size_t)z * N;
    const int n0 = elem_nodes[3 * (size_t)e];
    const int n1 = elem_nodes[3 * (size_t)e + 1];
    const int n2 = elem_nodes[3 * (size_t)e + 2];
    uv_max[idx] = vmax(vmax(tmax[row + n0], tmax[row + n1]), tmax[row + n2]);
    uv_min[idx] = vmin(vmin(tmin[row + n0], tmin[row + n1]), tmin[row + n2]);
  } else {
    uv_max[idx] = -big;
    uv_min[idx] = big;
  }
}

// ---------------------------------------------------------------------------
// Launch helpers
// ---------------------------------------------------------------------------

inline dim3 blocks_for(int n, int threads) {
  return dim3((n + threads - 1) / threads);
}

// incidence rows wider than this are refused (the wrapper checks first)
constexpr int kMaxDegree = 16;

template <int V>
using Int = std::integral_constant<int, V>;

// Calls f(Int<THREADS>) for the block sizes that have kernel instances and
// returns the launch's error; any other size is refused before a launch.
template <typename F>
int with_threads(int threads, F&& f) {
  switch (threads) {
    case 64: f(Int<64>{}); break;
    case 128: f(Int<128>{}); break;
    case 256: f(Int<256>{}); break;
    case 512: f(Int<512>{}); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// Calls f(Int<MAXD>, Int<THREADS>): the incidence slots in registers (8 or
// kMaxDegree, the least that holds KD) and the block size.  Rows of more
// than 8 slots are instantiated for blocks of at most kMaxWideThreads:
// their node kernels need more registers than a larger block leaves a
// thread (H-K12 and H-K34 would spill), so such a launch is refused.
constexpr int kMaxWideThreads = 128;

template <typename F>
int with_config(int KD, int threads, F&& f) {
  if (KD > 8 && threads > kMaxWideThreads) return cudaErrorInvalidValue;
  return with_threads(threads, [&](auto nt) {
    if constexpr (decltype(nt)::value <= kMaxWideThreads) {
      if (KD > 8) {
        f(Int<kMaxDegree>{}, nt);
        return;
      }
    }
    f(Int<8>{}, nt);
  });
}

template <typename T>
int launch_bounds(const void* lo, const void* ttf, const void* nd_other,
                  const void* nd_lev, const void* nd_num,
                  const void* nlev_nod, void* tmax, void* tmin, int L, int N,
                  int KD, int vlimit, int threads, int device, void* stream) {
  if (L < 1 || N < 1 || KD < 1 || KD > kMaxDegree) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_config(KD, threads, [&](auto d, auto nt) {
    constexpr int D = decltype(d)::value, TH = decltype(nt)::value;
    bounds_kernel<T, D, TH><<<blocks_for(N, TH), TH, 0, s>>>(
        (const T*)lo, (const T*)ttf, (const int*)nd_other, (const int*)nd_lev,
        (const int*)nd_num, (const int*)nlev_nod, (T*)tmax, (T*)tmin, L, N,
        KD, vlimit);
  });
}

template <typename T>
int launch_limit(const void* adf_v, const void* tmax, const void* tmin,
                 const void* adf_h, const void* area_inv, const void* nd_idx,
                 const void* nd_lev, const void* nd_sgn, const void* nd_num,
                 const void* nlev_nod, void* plus, void* minus,
                 void* adf_v_lim, void* adf_v_res, int L, int N, int Ed,
                 int KD, double dt, double eps, int threads, int device,
                 void* stream) {
  if (L < 1 || N < 1 || Ed < 1 || KD < 1 || KD > kMaxDegree)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_config(KD, threads, [&](auto d, auto nt) {
    constexpr int D = decltype(d)::value, TH = decltype(nt)::value;
    limit_kernel<T, D, TH><<<blocks_for(N, TH), TH, 0, s>>>(
        (const T*)adf_v, (const T*)tmax, (const T*)tmin, (const T*)adf_h,
        (const T*)area_inv, (const int*)nd_idx, (const int*)nd_lev,
        (const signed char*)nd_sgn, (const int*)nd_num, (const int*)nlev_nod,
        (T*)plus, (T*)minus, (T*)adf_v_lim, (T*)adf_v_res, L, N, Ed, KD,
        (T)dt, (T)eps);
  });
}

template <typename T>
int launch_limit_fused(const void* lo, const void* ttf, const void* adf_v,
                       const void* adf_h, const void* area_inv,
                       const void* nd_idx, const void* nd_other,
                       const void* nd_lev, const void* nd_sgn,
                       const void* nd_num, const void* nlev_nod, void* tmax,
                       void* tmin, void* plus, void* minus, void* adf_v_lim,
                       void* adf_v_res, int L, int N, int Ed, int KD,
                       int vlimit, double dt, double eps, int threads,
                       int device, void* stream) {
  if (L < 1 || N < 1 || Ed < 1 || KD < 1 || KD > kMaxDegree)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_config(KD, threads, [&](auto d, auto nt) {
    constexpr int D = decltype(d)::value, TH = decltype(nt)::value;
    limit_fused_kernel<T, D, TH><<<blocks_for(N, TH), TH, 0, s>>>(
        (const T*)lo, (const T*)ttf, (const T*)adf_v, (const T*)adf_h,
        (const T*)area_inv, (const int*)nd_idx, (const int*)nd_other,
        (const int*)nd_lev, (const signed char*)nd_sgn, (const int*)nd_num,
        (const int*)nlev_nod, (T*)tmax, (T*)tmin, (T*)plus, (T*)minus,
        (T*)adf_v_lim, (T*)adf_v_res, L, N, Ed, KD, vlimit, (T)dt, (T)eps);
  });
}

template <typename T>
int launch_update_fused(const void* plus, const void* minus,
                        const void* adf_v_lim, const void* adf_h,
                        const void* ttf, const void* hnode,
                        const void* hnode_new, const void* lo,
                        const void* dvin, const void* dhin,
                        const void* area_inv, const void* nd_idx,
                        const void* nd_other, const void* nd_lev,
                        const void* nd_sgn, const void* nd_wrt,
                        const void* nd_num, const void* nlev_nod,
                        const void* ed_free, void* o1, void* o2,
                        void* adf_h_lim, void* adf_h_res, int L, int N,
                        int Ed, int KD, int n_free, double dt, int iter_yn,
                        int threads, int device, void* stream) {
  if (L < 1 || N < 1 || Ed < 1 || KD < 1 || KD > kMaxDegree || n_free < 0 ||
      n_free > Ed)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_config(KD, threads, [&](auto d, auto nt) {
    constexpr int D = decltype(d)::value, TH = decltype(nt)::value;
    update_fused_kernel<T, D, TH><<<blocks_for(N > n_free ? N : n_free, TH),
                                    TH, 0, s>>>(
        (const T*)plus, (const T*)minus, (const T*)adf_v_lim,
        (const T*)adf_h, (const T*)ttf, (const T*)hnode,
        (const T*)hnode_new, (const T*)lo, (const T*)dvin, (const T*)dhin,
        (const T*)area_inv, (const int*)nd_idx, (const int*)nd_other,
        (const int*)nd_lev, (const signed char*)nd_sgn,
        (const signed char*)nd_wrt, (const int*)nd_num, (const int*)nlev_nod,
        (const int*)ed_free, (T*)o1, (T*)o2, (T*)adf_h_lim, (T*)adf_h_res,
        L, N, Ed, KD, n_free, (T)dt, iter_yn);
  });
}

template <typename T>
int launch_b3h(const void* plus, const void* minus, const void* adf_h,
               const void* edges, const void* nlev_edge, void* adf_h_lim,
               void* adf_h_res, int L, int N, int Ed, int threads, int device,
               void* stream) {
  if (L < 1 || L > 65535 || N < 1 || Ed < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_threads(threads, [&](auto nt) {
    constexpr int TH = decltype(nt)::value;
    const dim3 grid((Ed + TH - 1) / TH, L);
    b3h_kernel<T, TH><<<grid, TH, 0, s>>>(
        (const T*)plus, (const T*)minus, (const T*)adf_h, (const int*)edges,
        (const int*)nlev_edge, (T*)adf_h_lim, (T*)adf_h_res, N, Ed);
  });
}

template <typename T>
int launch_b3h_fixup(const void* plus, const void* minus, const void* adf_h,
                     const void* edges, const void* nlev_edge,
                     const void* ids, void* adf_h_lim, void* adf_h_res,
                     int L, int N, int Ed, int n_ids, int threads, int device,
                     void* stream) {
  if (L < 1 || L > 65535 || N < 1 || Ed < 1 || n_ids < 1)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_threads(threads, [&](auto nt) {
    constexpr int TH = decltype(nt)::value;
    const dim3 grid((n_ids + TH - 1) / TH, L);
    b3h_fixup_kernel<T, TH><<<grid, TH, 0, s>>>(
        (const T*)plus, (const T*)minus, (const T*)adf_h, (const int*)edges,
        (const int*)nlev_edge, (const int*)ids, (T*)adf_h_lim,
        (T*)adf_h_res, N, Ed, n_ids);
  });
}

template <typename T>
int launch_update(const void* adf_v_lim, const void* adf_h_lim,
                  const void* ttf, const void* hnode, const void* hnode_new,
                  const void* lo, const void* dvin, const void* dhin,
                  const void* area_inv, const void* nd_idx,
                  const void* nd_lev, const void* nd_sgn, const void* nd_num,
                  const void* nlev_nod, void* o1, void* o2, int L, int N,
                  int Ed, int KD, double dt, int iter_yn, int threads,
                  int device, void* stream) {
  if (L < 1 || N < 1 || Ed < 1 || KD < 1 || KD > kMaxDegree)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_config(KD, threads, [&](auto d, auto nt) {
    constexpr int D = decltype(d)::value, TH = decltype(nt)::value;
    update_kernel<T, D, TH><<<blocks_for(N, TH), TH, 0, s>>>(
        (const T*)adf_v_lim, (const T*)adf_h_lim, (const T*)ttf,
        (const T*)hnode, (const T*)hnode_new, (const T*)lo, (const T*)dvin,
        (const T*)dhin, (const T*)area_inv, (const int*)nd_idx,
        (const int*)nd_lev, (const signed char*)nd_sgn, (const int*)nd_num,
        (const int*)nlev_nod, (T*)o1, (T*)o2, L, N, Ed, KD, (T)dt, iter_yn);
  });
}

template <typename T>
int launch_a2(const void* tmax, const void* tmin, const void* elem_nodes,
              const void* nlev_elem, void* uv_max, void* uv_min, int L, int N,
              int E, double big, int threads, int device, void* stream) {
  if (L < 1 || L > 65535 || N < 1 || E < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_threads(threads, [&](auto nt) {
    constexpr int TH = decltype(nt)::value;
    const dim3 grid((E + TH - 1) / TH, L);
    a2_kernel<T, TH><<<grid, TH, 0, s>>>(
        (const T*)tmax, (const T*)tmin, (const int*)elem_nodes,
        (const int*)nlev_elem, (T*)uv_max, (T*)uv_min, N, E, (T)big);
  });
}

}  // namespace

// Plain C interface.  Every pointer is a device pointer (or null for an
// absent optional output); ``threads`` is the block size (64, 128, 256 or
// 512, else cudaErrorInvalidValue and no launch); ``stream`` is a
// cudaStream_t.  Each launcher returns cudaGetLastError() after its launch
// (0 on success) and does not synchronise.
extern "C" {

#define FCT_BOUNDS_ARGS                                                     \
  const void *lo, const void *ttf, const void *nd_other, const void *nd_lev, \
      const void *nd_num, const void *nlev_nod, void *tmax, void *tmin,     \
      int L, int N, int KD, int vlimit, int threads, int device,            \
      void *stream
#define FCT_BOUNDS_CALL \
  lo, ttf, nd_other, nd_lev, nd_num, nlev_nod, tmax, tmin, L, N, KD, vlimit, \
      threads, device, stream

int fct_bounds_f32(FCT_BOUNDS_ARGS) { return launch_bounds<float>(FCT_BOUNDS_CALL); }
int fct_bounds_f64(FCT_BOUNDS_ARGS) { return launch_bounds<double>(FCT_BOUNDS_CALL); }

#define FCT_LIMIT_ARGS                                                       \
  const void *adf_v, const void *tmax, const void *tmin, const void *adf_h,  \
      const void *area_inv, const void *nd_idx, const void *nd_lev,          \
      const void *nd_sgn, const void *nd_num, const void *nlev_nod,          \
      void *plus, void *minus, void *adf_v_lim, void *adf_v_res, int L,      \
      int N, int Ed, int KD, double dt, double eps, int threads, int device, \
      void *stream
#define FCT_LIMIT_CALL                                                      \
  adf_v, tmax, tmin, adf_h, area_inv, nd_idx, nd_lev, nd_sgn, nd_num,       \
      nlev_nod, plus, minus, adf_v_lim, adf_v_res, L, N, Ed, KD, dt, eps,   \
      threads, device, stream

int fct_limit_f32(FCT_LIMIT_ARGS) { return launch_limit<float>(FCT_LIMIT_CALL); }
int fct_limit_f64(FCT_LIMIT_ARGS) { return launch_limit<double>(FCT_LIMIT_CALL); }

#define FCT_LIMIT_FUSED_ARGS                                                \
  const void *lo, const void *ttf, const void *adf_v, const void *adf_h,    \
      const void *area_inv, const void *nd_idx, const void *nd_other,       \
      const void *nd_lev, const void *nd_sgn, const void *nd_num,           \
      const void *nlev_nod, void *tmax, void *tmin, void *plus,             \
      void *minus, void *adf_v_lim, void *adf_v_res, int L, int N, int Ed,  \
      int KD, int vlimit, double dt, double eps, int threads, int device,   \
      void *stream
#define FCT_LIMIT_FUSED_CALL                                                \
  lo, ttf, adf_v, adf_h, area_inv, nd_idx, nd_other, nd_lev, nd_sgn,        \
      nd_num, nlev_nod, tmax, tmin, plus, minus, adf_v_lim, adf_v_res, L,   \
      N, Ed, KD, vlimit, dt, eps, threads, device, stream

int fct_limit_fused_f32(FCT_LIMIT_FUSED_ARGS) {
  return launch_limit_fused<float>(FCT_LIMIT_FUSED_CALL);
}
int fct_limit_fused_f64(FCT_LIMIT_FUSED_ARGS) {
  return launch_limit_fused<double>(FCT_LIMIT_FUSED_CALL);
}

#define FCT_UPDATE_ARGS                                                      \
  const void *plus, const void *minus, const void *adf_v_lim,                \
      const void *adf_h, const void *ttf, const void *hnode,                 \
      const void *hnode_new, const void *lo, const void *dvin,               \
      const void *dhin, const void *area_inv, const void *nd_idx,            \
      const void *nd_other, const void *nd_lev, const void *nd_sgn,          \
      const void *nd_wrt, const void *nd_num, const void *nlev_nod,          \
      const void *ed_free, void *o1, void *o2, void *adf_h_lim,              \
      void *adf_h_res, int L, int N, int Ed, int KD, int n_free, double dt,  \
      int iter_yn, int threads, int device, void *stream
#define FCT_UPDATE_CALL                                                     \
  plus, minus, adf_v_lim, adf_h, ttf, hnode, hnode_new, lo, dvin, dhin,     \
      area_inv, nd_idx, nd_other, nd_lev, nd_sgn, nd_wrt, nd_num, nlev_nod, \
      ed_free, o1, o2, adf_h_lim, adf_h_res, L, N, Ed, KD, n_free, dt,      \
      iter_yn, threads, device, stream

int fct_update_fused_f32(FCT_UPDATE_ARGS) {
  return launch_update_fused<float>(FCT_UPDATE_CALL);
}
int fct_update_fused_f64(FCT_UPDATE_ARGS) {
  return launch_update_fused<double>(FCT_UPDATE_CALL);
}

#define FCT_B3H_ARGS                                                        \
  const void *plus, const void *minus, const void *adf_h, const void *edges, \
      const void *nlev_edge, void *adf_h_lim, void *adf_h_res, int L, int N, \
      int Ed, int threads, int device, void *stream
#define FCT_B3H_CALL                                                        \
  plus, minus, adf_h, edges, nlev_edge, adf_h_lim, adf_h_res, L, N, Ed,     \
      threads, device, stream

int fct_b3h_f32(FCT_B3H_ARGS) { return launch_b3h<float>(FCT_B3H_CALL); }
int fct_b3h_f64(FCT_B3H_ARGS) { return launch_b3h<double>(FCT_B3H_CALL); }

#define FCT_B3H_FIXUP_ARGS                                                  \
  const void *plus, const void *minus, const void *adf_h, const void *edges, \
      const void *nlev_edge, const void *ids, void *adf_h_lim,              \
      void *adf_h_res, int L, int N, int Ed, int n_ids, int threads,        \
      int device, void *stream
#define FCT_B3H_FIXUP_CALL                                                  \
  plus, minus, adf_h, edges, nlev_edge, ids, adf_h_lim, adf_h_res, L, N,    \
      Ed, n_ids, threads, device, stream

int fct_b3h_fixup_f32(FCT_B3H_FIXUP_ARGS) {
  return launch_b3h_fixup<float>(FCT_B3H_FIXUP_CALL);
}
int fct_b3h_fixup_f64(FCT_B3H_FIXUP_ARGS) {
  return launch_b3h_fixup<double>(FCT_B3H_FIXUP_CALL);
}

#define FCT_UPDATE_SPLIT_ARGS                                               \
  const void *adf_v_lim, const void *adf_h_lim, const void *ttf,            \
      const void *hnode, const void *hnode_new, const void *lo,             \
      const void *dvin, const void *dhin, const void *area_inv,             \
      const void *nd_idx, const void *nd_lev, const void *nd_sgn,           \
      const void *nd_num, const void *nlev_nod, void *o1, void *o2, int L,  \
      int N, int Ed, int KD, double dt, int iter_yn, int threads,           \
      int device, void *stream
#define FCT_UPDATE_SPLIT_CALL                                               \
  adf_v_lim, adf_h_lim, ttf, hnode, hnode_new, lo, dvin, dhin, area_inv,    \
      nd_idx, nd_lev, nd_sgn, nd_num, nlev_nod, o1, o2, L, N, Ed, KD, dt,   \
      iter_yn, threads, device, stream

int fct_update_f32(FCT_UPDATE_SPLIT_ARGS) {
  return launch_update<float>(FCT_UPDATE_SPLIT_CALL);
}
int fct_update_f64(FCT_UPDATE_SPLIT_ARGS) {
  return launch_update<double>(FCT_UPDATE_SPLIT_CALL);
}

#define FCT_A2_ARGS                                                         \
  const void *tmax, const void *tmin, const void *elem_nodes,               \
      const void *nlev_elem, void *uv_max, void *uv_min, int L, int N,      \
      int E, double big, int threads, int device, void *stream
#define FCT_A2_CALL                                                         \
  tmax, tmin, elem_nodes, nlev_elem, uv_max, uv_min, L, N, E, big, threads, \
      device, stream

int fct_a2_f32(FCT_A2_ARGS) { return launch_a2<float>(FCT_A2_CALL); }
int fct_a2_f64(FCT_A2_ARGS) { return launch_a2<double>(FCT_A2_CALL); }

}  // extern "C"
