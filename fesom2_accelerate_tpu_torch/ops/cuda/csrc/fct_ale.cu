// FCT-ALE kernels for Hopper (sm_90a), templated on float/double, with
// extern "C" launchers that are loaded through ctypes (ops/cuda/build.py,
// ops/cuda/kernels.py):
//   * the single-device chain K1 bounds -> K2 limit -> K34 update_fused;
//   * the split chain of a sharded step, K1 -> K2 -> K3 b3h -> halo
//     exchange -> K3fix b3h_fixup -> K4 update: K3 limits every edge on the
//     pre-exchange factors, K3fix redoes the edges that touch a halo node
//     with the exchanged ones, K4 is stage c from the limited edge fluxes.
//
// Each kernel computes what the JAX package's Pallas kernel of the same
// role computes, on natural level-major shapes: node fields [L, N],
// interface fields [L+1, N], edge fields [L, Ed].  None of the TPU layout
// machinery carries over (one-hot MXU contractions, DIA lane rolls, packed
// home slots, DMA windows, 128-lane tiles): all of it stands in for the
// vector gather that Hopper has.
//
// Design shared by the node kernels (K1, K2, K34, K4):
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
// The edge kernels (K3, K3fix) run one thread per (edge, level),
// consecutive threads on consecutive edges of one level.
// All are bound by device-memory traffic (a few flops per byte); the
// neighbour gathers at each level hit L2/L1 because the mesh numbering
// keeps edge-neighbours within about min(nx, ny) node indices.
//
// Built without --use_fast_math: b2's divisions and every limiter
// selection stay IEEE.  nvcc still contracts a*b+c into FMA, one reason
// (with the order of the incident-edge sums) that K2, K34 and K4 agree with
// their plain versions to a relative error and not bit for bit.  K1 does
// only max/min, selects and one subtraction, and K3/K3fix only selects and
// one product per output, so those are bit-exact.

#include <cuda_runtime.h>
#include <cstddef>

namespace {

constexpr int kThreads = 128;

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

template <typename T, int MAXD>
__global__ void __launch_bounds__(kThreads)
bounds_kernel(const T* __restrict__ lo, const T* __restrict__ ttf,
              const int* __restrict__ nd_other,
              const int* __restrict__ nd_lev,
              const int* __restrict__ nd_num,
              const int* __restrict__ nlev_nod, T* __restrict__ tmax_out,
              T* __restrict__ tmin_out, int L, int N, int KD, int vlimit) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const T big = T(1e30);
  const int nlev = nlev_nod[n];
  const int num = nd_num[n];
  int oth[MAXD], lev[MAXD];
#pragma unroll
  for (int k = 0; k < MAXD; ++k) {
    const bool ok = k < num;
    oth[k] = ok ? nd_other[(size_t)n * KD + k] : n;
    lev[k] = ok ? nd_lev[(size_t)n * KD + k] : 0;
  }

  // window registers: level z-1 (padded), z, z+1
  T pmax = -big, pmin = big;        // cluster bounds at z-1
  T pa_hi = -big, pa_lo = big;      // a1max at z-1 (max / min window pads)
  Level<T> cur = cluster_level<T, MAXD>(lo, ttf, 0, n, N, nlev, oth, lev);
  for (int z = 0; z < L; ++z) {
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
    const bool act = z < nlev - 1;
    const bool plain = (z == 0) || (z >= nlev - 2);
    T smax = cur.cmax, smin = cur.cmin;
    if (!plain) {
      if (vlimit == 1) {
        smax = vmax(vmax(pmax, cur.cmax), nxt.cmax);
        smin = vmin(vmin(pmin, cur.cmin), nxt.cmin);
      } else {
        // vlimit 2/3: both windows over a1's fct_ttf_max
        const T wmax = vmax(vmax(pa_hi, cur.a1max), na_hi);
        const T wmin = vmin(vmin(pa_lo, cur.a1max), na_lo);
        if (vlimit == 2) {
          smax = vmax(cur.cmax, wmax);
          smin = vmin(cur.cmin, wmin);
        } else {
          smax = vmin(cur.cmax, wmax);
          smin = vmax(cur.cmin, wmin);
        }
      }
    }
    const size_t idx = (size_t)z * N + n;
    tmax_out[idx] = act ? smax - cur.lo : T(0);
    tmin_out[idx] = act ? smin - cur.lo : T(0);
    pmax = cur.cmax;
    pmin = cur.cmin;
    pa_hi = cur.a1max;
    pa_lo = cur.a1max;
    cur = nxt;
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

template <typename T, int MAXD>
__global__ void __launch_bounds__(kThreads)
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
        const T x = first[k] ? f : -f;
        gp += vmax(T(0), x);
        gm += vmin(T(0), x);
      }
    }
    const bool act = z < nlev - 1;
    // b2 (kernels/fct_ale_b2.cu:10-11)
    const T ai = area_inv[idx];
    const T fplus = (pv + gp) * dt * ai + eps;
    const T fminus = (mv + gm) * dt * ai - eps;
    const T fp = act ? vmin(T(1), tmax[idx] / fplus) : T(0);
    const T fm = act ? vmin(T(1), tmin[idx] / fminus) : T(0);
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

template <typename T, int MAXD>
__global__ void __launch_bounds__(kThreads)
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
b3h_kernel(const T* __restrict__ plus, const T* __restrict__ minus,
           const T* __restrict__ adf_h, const int* __restrict__ edges,
           const int* __restrict__ nlev_edge, T* __restrict__ adf_h_lim,
           T* __restrict__ adf_h_res, int N, int Ed) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= Ed) return;
  b3h_edge(plus, minus, adf_h, edges, nlev_edge, adf_h_lim, adf_h_res,
           (int)blockIdx.y, e, N, Ed);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
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

template <typename T, int MAXD>
__global__ void __launch_bounds__(kThreads)
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

inline dim3 grid_for(int N) { return dim3((N + kThreads - 1) / kThreads); }

// incidence rows wider than this are refused (the wrapper checks first)
constexpr int kMaxDegree = 16;

template <typename T>
int launch_bounds(const void* lo, const void* ttf, const void* nd_other,
                  const void* nd_lev, const void* nd_num,
                  const void* nlev_nod, void* tmax, void* tmin, int L, int N,
                  int KD, int vlimit, int device, void* stream) {
  if (L < 1 || N < 1 || KD < 1 || KD > kMaxDegree) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto args = [&](auto kernel) {
    kernel<<<grid_for(N), kThreads, 0, s>>>(
        (const T*)lo, (const T*)ttf, (const int*)nd_other, (const int*)nd_lev,
        (const int*)nd_num, (const int*)nlev_nod, (T*)tmax, (T*)tmin, L, N,
        KD, vlimit);
  };
  if (KD <= 8) args(bounds_kernel<T, 8>);
  else args(bounds_kernel<T, kMaxDegree>);
  return cudaGetLastError();
}

template <typename T>
int launch_limit(const void* adf_v, const void* tmax, const void* tmin,
                 const void* adf_h, const void* area_inv, const void* nd_idx,
                 const void* nd_lev, const void* nd_sgn, const void* nd_num,
                 const void* nlev_nod, void* plus, void* minus,
                 void* adf_v_lim, void* adf_v_res, int L, int N, int Ed,
                 int KD, double dt, double eps, int device, void* stream) {
  if (L < 1 || N < 1 || Ed < 1 || KD < 1 || KD > kMaxDegree)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto args = [&](auto kernel) {
    kernel<<<grid_for(N), kThreads, 0, s>>>(
        (const T*)adf_v, (const T*)tmax, (const T*)tmin, (const T*)adf_h,
        (const T*)area_inv, (const int*)nd_idx, (const int*)nd_lev,
        (const signed char*)nd_sgn, (const int*)nd_num, (const int*)nlev_nod,
        (T*)plus, (T*)minus, (T*)adf_v_lim, (T*)adf_v_res, L, N, Ed, KD,
        (T)dt, (T)eps);
  };
  if (KD <= 8) args(limit_kernel<T, 8>);
  else args(limit_kernel<T, kMaxDegree>);
  return cudaGetLastError();
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
                        int device, void* stream) {
  if (L < 1 || N < 1 || Ed < 1 || KD < 1 || KD > kMaxDegree || n_free < 0 ||
      n_free > Ed)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto args = [&](auto kernel) {
    kernel<<<grid_for(N > n_free ? N : n_free), kThreads, 0, s>>>(
        (const T*)plus, (const T*)minus, (const T*)adf_v_lim,
        (const T*)adf_h, (const T*)ttf, (const T*)hnode,
        (const T*)hnode_new, (const T*)lo, (const T*)dvin, (const T*)dhin,
        (const T*)area_inv, (const int*)nd_idx, (const int*)nd_other,
        (const int*)nd_lev, (const signed char*)nd_sgn,
        (const signed char*)nd_wrt, (const int*)nd_num, (const int*)nlev_nod,
        (const int*)ed_free, (T*)o1, (T*)o2, (T*)adf_h_lim, (T*)adf_h_res,
        L, N, Ed, KD, n_free, (T)dt, iter_yn);
  };
  if (KD <= 8) args(update_fused_kernel<T, 8>);
  else args(update_fused_kernel<T, kMaxDegree>);
  return cudaGetLastError();
}

template <typename T>
int launch_b3h(const void* plus, const void* minus, const void* adf_h,
               const void* edges, const void* nlev_edge, void* adf_h_lim,
               void* adf_h_res, int L, int N, int Ed, int device,
               void* stream) {
  if (L < 1 || L > 65535 || N < 1 || Ed < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const dim3 grid((Ed + kThreads - 1) / kThreads, L);
  b3h_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      (const T*)plus, (const T*)minus, (const T*)adf_h, (const int*)edges,
      (const int*)nlev_edge, (T*)adf_h_lim, (T*)adf_h_res, N, Ed);
  return cudaGetLastError();
}

template <typename T>
int launch_b3h_fixup(const void* plus, const void* minus, const void* adf_h,
                     const void* edges, const void* nlev_edge,
                     const void* ids, void* adf_h_lim, void* adf_h_res,
                     int L, int N, int Ed, int n_ids, int device,
                     void* stream) {
  if (L < 1 || L > 65535 || N < 1 || Ed < 1 || n_ids < 1)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const dim3 grid((n_ids + kThreads - 1) / kThreads, L);
  b3h_fixup_kernel<T><<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      (const T*)plus, (const T*)minus, (const T*)adf_h, (const int*)edges,
      (const int*)nlev_edge, (const int*)ids, (T*)adf_h_lim, (T*)adf_h_res,
      N, Ed, n_ids);
  return cudaGetLastError();
}

template <typename T>
int launch_update(const void* adf_v_lim, const void* adf_h_lim,
                  const void* ttf, const void* hnode, const void* hnode_new,
                  const void* lo, const void* dvin, const void* dhin,
                  const void* area_inv, const void* nd_idx,
                  const void* nd_lev, const void* nd_sgn, const void* nd_num,
                  const void* nlev_nod, void* o1, void* o2, int L, int N,
                  int Ed, int KD, double dt, int iter_yn, int device,
                  void* stream) {
  if (L < 1 || N < 1 || Ed < 1 || KD < 1 || KD > kMaxDegree)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto args = [&](auto kernel) {
    kernel<<<grid_for(N), kThreads, 0, s>>>(
        (const T*)adf_v_lim, (const T*)adf_h_lim, (const T*)ttf,
        (const T*)hnode, (const T*)hnode_new, (const T*)lo, (const T*)dvin,
        (const T*)dhin, (const T*)area_inv, (const int*)nd_idx,
        (const int*)nd_lev, (const signed char*)nd_sgn, (const int*)nd_num,
        (const int*)nlev_nod, (T*)o1, (T*)o2, L, N, Ed, KD, (T)dt, iter_yn);
  };
  if (KD <= 8) args(update_kernel<T, 8>);
  else args(update_kernel<T, kMaxDegree>);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface.  Every pointer is a device pointer (or null for an
// absent optional output); ``stream`` is a cudaStream_t.  Each launcher
// returns cudaGetLastError() after its launch (0 on success) and does not
// synchronise.
extern "C" {

#define FCT_BOUNDS_ARGS                                                     \
  const void *lo, const void *ttf, const void *nd_other, const void *nd_lev, \
      const void *nd_num, const void *nlev_nod, void *tmax, void *tmin,     \
      int L, int N, int KD, int vlimit, int device, void *stream
#define FCT_BOUNDS_CALL \
  lo, ttf, nd_other, nd_lev, nd_num, nlev_nod, tmax, tmin, L, N, KD, vlimit, \
      device, stream

int fct_bounds_f32(FCT_BOUNDS_ARGS) { return launch_bounds<float>(FCT_BOUNDS_CALL); }
int fct_bounds_f64(FCT_BOUNDS_ARGS) { return launch_bounds<double>(FCT_BOUNDS_CALL); }

#define FCT_LIMIT_ARGS                                                       \
  const void *adf_v, const void *tmax, const void *tmin, const void *adf_h,  \
      const void *area_inv, const void *nd_idx, const void *nd_lev,          \
      const void *nd_sgn, const void *nd_num, const void *nlev_nod,          \
      void *plus, void *minus, void *adf_v_lim, void *adf_v_res, int L,      \
      int N, int Ed, int KD, double dt, double eps, int device, void *stream
#define FCT_LIMIT_CALL                                                      \
  adf_v, tmax, tmin, adf_h, area_inv, nd_idx, nd_lev, nd_sgn, nd_num,       \
      nlev_nod, plus, minus, adf_v_lim, adf_v_res, L, N, Ed, KD, dt, eps,   \
      device, stream

int fct_limit_f32(FCT_LIMIT_ARGS) { return launch_limit<float>(FCT_LIMIT_CALL); }
int fct_limit_f64(FCT_LIMIT_ARGS) { return launch_limit<double>(FCT_LIMIT_CALL); }

#define FCT_UPDATE_ARGS                                                      \
  const void *plus, const void *minus, const void *adf_v_lim,                \
      const void *adf_h, const void *ttf, const void *hnode,                 \
      const void *hnode_new, const void *lo, const void *dvin,               \
      const void *dhin, const void *area_inv, const void *nd_idx,            \
      const void *nd_other, const void *nd_lev, const void *nd_sgn,          \
      const void *nd_wrt, const void *nd_num, const void *nlev_nod,          \
      const void *ed_free, void *o1, void *o2, void *adf_h_lim,              \
      void *adf_h_res, int L, int N, int Ed, int KD, int n_free, double dt,  \
      int iter_yn, int device, void *stream
#define FCT_UPDATE_CALL                                                     \
  plus, minus, adf_v_lim, adf_h, ttf, hnode, hnode_new, lo, dvin, dhin,     \
      area_inv, nd_idx, nd_other, nd_lev, nd_sgn, nd_wrt, nd_num, nlev_nod, \
      ed_free, o1, o2, adf_h_lim, adf_h_res, L, N, Ed, KD, n_free, dt,      \
      iter_yn, device, stream

int fct_update_fused_f32(FCT_UPDATE_ARGS) {
  return launch_update_fused<float>(FCT_UPDATE_CALL);
}
int fct_update_fused_f64(FCT_UPDATE_ARGS) {
  return launch_update_fused<double>(FCT_UPDATE_CALL);
}

#define FCT_B3H_ARGS                                                        \
  const void *plus, const void *minus, const void *adf_h, const void *edges, \
      const void *nlev_edge, void *adf_h_lim, void *adf_h_res, int L, int N, \
      int Ed, int device, void *stream
#define FCT_B3H_CALL                                                        \
  plus, minus, adf_h, edges, nlev_edge, adf_h_lim, adf_h_res, L, N, Ed,     \
      device, stream

int fct_b3h_f32(FCT_B3H_ARGS) { return launch_b3h<float>(FCT_B3H_CALL); }
int fct_b3h_f64(FCT_B3H_ARGS) { return launch_b3h<double>(FCT_B3H_CALL); }

#define FCT_B3H_FIXUP_ARGS                                                  \
  const void *plus, const void *minus, const void *adf_h, const void *edges, \
      const void *nlev_edge, const void *ids, void *adf_h_lim,              \
      void *adf_h_res, int L, int N, int Ed, int n_ids, int device,         \
      void *stream
#define FCT_B3H_FIXUP_CALL                                                  \
  plus, minus, adf_h, edges, nlev_edge, ids, adf_h_lim, adf_h_res, L, N,    \
      Ed, n_ids, device, stream

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
      int N, int Ed, int KD, double dt, int iter_yn, int device,            \
      void *stream
#define FCT_UPDATE_SPLIT_CALL                                               \
  adf_v_lim, adf_h_lim, ttf, hnode, hnode_new, lo, dvin, dhin, area_inv,    \
      nd_idx, nd_lev, nd_sgn, nd_num, nlev_nod, o1, o2, L, N, Ed, KD, dt,   \
      iter_yn, device, stream

int fct_update_f32(FCT_UPDATE_SPLIT_ARGS) {
  return launch_update<float>(FCT_UPDATE_SPLIT_CALL);
}
int fct_update_f64(FCT_UPDATE_SPLIT_ARGS) {
  return launch_update<double>(FCT_UPDATE_SPLIT_CALL);
}

}  // extern "C"
