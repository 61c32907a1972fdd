// FCT-ALE kernels for Hopper (sm_90a), templated on float/double, with
// extern "C" launchers that are loaded through ctypes (ops/cuda/build.py,
// ops/cuda/kernels.py):
//   * the single-device chain K12 limit_fused (K1 and K2 in one pass) ->
//     K3 b3h -> K4 update, or any of its other forms: K1 bounds -> K2
//     limit in place of K12, and K34 update_fused in place of K3 -> K4;
//   * the split chain of a sharded step, K1 -> K2 -> K3 b3h -> halo
//     exchange -> K4 update in its FIX form: K3 limits every edge on the
//     pre-exchange factors; K4-fix limits again, from the exchanged ones,
//     the edges that touch a halo node, writes them back and sums them into
//     stage c with K3's other edges.  K3fix b3h_fixup (those edges alone)
//     followed by the plain K4 computes the same bits in two launches: it
//     is the witness the fold is held against;
//   * A2 a2, the standalone element bounds of the tuning harness.
//
// Each kernel computes what the JAX package's Pallas kernel of the same
// role computes, on natural level-major shapes: node fields [L, N],
// interface fields [L+1, N], edge fields [L, Ed], element fields [L, E].
// None of the TPU layout machinery carries over (one-hot MXU contractions,
// DIA lane rolls, packed home slots, DMA windows, 128-lane tiles): all of it
// stands in for the vector gather that Hopper has.
//
// Design of the kernels.  All are bound by device-memory traffic (a few
// flops per byte); the neighbour gathers at each level hit L2/L1 because
// the mesh numbering keeps neighbours within about min(nx, ny) node indices.
//   * Tiled node kernels (K1, K2, K12, K34, K4).  A block covers a tile of
//     kTileNodes consecutive nodes (one warp's width) and a chunk of
//     consecutive levels (K1 32, K2 32, K12 24, K34 16, K4 32); lane l of
//     every warp holds node n0 + l, and the warps take the chunk's levels
//     in turn.  No thread walks the whole column, and the grid has many
//     blocks per SM (core2: 3,977 tiles x 2 or 3 chunks, 5 to 9 waves; a
//     part of a 4-part core2 step, 1,014 tiles x 2 or 3, more than one
//     wave), so the card fills whatever each thread's registers.  Where a
//     level needs its neighbour's values (the vertical window, b3v's z-1
//     factors), the block computes them into shared memory first, one
//     level past the chunk where needed, and reads them from there.  K1
//     computes the cluster bounds of the chunk and one level either side,
//     then applies the window.  K2 computes its factors of the chunk and
//     the level above it, then b3v.  K12 does both, one level further up.
//     K34 limits the edges that start in its tile (an index range, ed_ptr
//     of ops/meshdata.py: edges are sorted by their first endpoint) one
//     thread per (edge, level), writing them coalesced and keeping them in
//     shared memory, then sums each node's incident fluxes from there.  K4
//     sums each node's limited fluxes (its tile's incidence rows staged in
//     shared memory, as K34's) and applies stage c, every level on its
//     own.  No node kernel walks a column any more.
//     K4's FIX form limits the part's halo edges in its node sum as K34
//     limits the edges that cross its tile (see update_kernel).
//   * Edge and element kernels (K3, K3fix, A2): one thread per (edge or
//     element, level), consecutive threads on consecutive entities of one
//     level.
// Consecutive threads read consecutive nodes of one level, so node-field
// accesses coalesce and the [L, N] layout stays the API layout.  Every
// edge->node sum is a gather over the node's incident edges in slot order:
// no atomics, so results are identical from run to run.
//
// The tracer axis.  K1, K2, K12, K3, K3fix, K4 and K34 take Tb tracers in
// one launch, as their Pallas kernels take a (tiles, tracers) grid: each
// per-tracer field is tracer-major ([Tb, L, N], [Tb, L+1, N], [Tb, L, Ed],
// tracer t at t times one tracer's size), while hnode, hnode_new, area_inv
// and every mesh row are shared.  The blocks are ordered tracer-minor on
// gridDim.x (tracer_block): block b of tracer t is b * Tb + t, so the Tb
// blocks of one tile or edge block run together and read its incidence
// rows from L2 after the first.  K3, K3fix, K12 and K34 move their
// per-tracer pointers to the tracer's fields; K1 adds the tracer's offset
// to its indices, and K2 and K4 index the tracer's fields by row (its
// first node row t * L, its first interface row t * (L+1)), since a moved
// pointer held across their loops takes two registers of its own (eight
// of them pushed the f64 node-threaded H-K2 into spills).  K12's moved
// pointers are the same for every thread of a block, so ptxas keeps them
// in uniform registers: indexed by row instead, K12 at Tb = 2 ran 5% (f32)
// to 15% (f64) slower a tracer than at Tb = 1 (core2, H100), with moved
// pointers 7% (f32) and 2% (f64) faster.  Either way the single-tracer
// body runs unchanged, so each tracer's outputs are bit-identical to a
// Tb = 1 launch on its slice.  Each of the seven is
// compiled twice (template flag TRACERS): a Tb = 1 launch takes the
// instance without the axis, in which the tracer is 0 at compile time and
// every offset folds away, so the single-tracer path runs the code it ran
// before the axis (with the axis in every instance, the Tb = 1 launches
// ran slower).  K12's Pallas kernel takes no tracer axis; the whole-mesh
// step runs K12 -> K3 -> K4 at every tracer count (ops/cuda/step.py), so
// K12 takes the axis that K1 and K2 took before it.  A2 (and H-S2R) take
// none, as their Pallas kernels take none.
//
// Launch configuration: every launcher takes the threads per block (64,
// 128, 256 or 512; 128 is the default the wrappers pass) and every kernel
// is instantiated once per block size with __launch_bounds__ of that size
// (min_blocks below), so a larger block gets a register cap that fits it.
// In a tiled kernel the block size sets how many warps share a tile's
// levels; the tile itself does not change.  The node kernels' 16-slot
// instances (meshes of node degree > 8) exist for 64 and 128 threads only:
// at 256 or 512 those that hold a row in registers would spill.  The
// tuning harness (utils/tuning.py) sweeps this, as the JAX harness sweeps
// the Pallas tile and chunk sizes.
//
// Built without --use_fast_math: b2's divisions and every limiter
// selection stay IEEE.  nvcc still contracts a*b+c into FMA, one reason
// (with the order of the incident-edge sums) that K2, K12, K34 and K4 agree
// with their plain versions to a relative error and not bit for bit.  K1
// and A2 do only max/min, selects and one subtraction, and K3/K3fix only
// selects and one product per output, so those are bit-exact.  K34 rounds
// each limited flux on its own (mul_rn) and sums in K4's slot order, so it
// gives the bits of K3 -> K4, and K4's FIX form, which rounds its halo
// edges' limited fluxes so too, the bits of K3fix -> K4.

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

// A product rounded on its own: nvcc never contracts it into a following
// sum.
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}

// The tracer of this block and the block's index within that tracer's
// grid: blocks are ordered tracer-minor (see the note at the top).  In an
// instance without the tracer axis (TRACERS false, the Tb = 1 launches)
// the tracer is 0 at compile time, so every tracer offset folds away.
struct TracerBlock {
  int t;       // tracer
  unsigned b;  // block within the tracer's grid (unsigned, as blockIdx.x)
};

template <bool TRACERS>
__device__ __forceinline__ TracerBlock tracer_block(int Tb) {
  if constexpr (TRACERS) {
    return {(int)(blockIdx.x % (unsigned)Tb), blockIdx.x / (unsigned)Tb};
  } else {
    return {0, blockIdx.x};
  }
}

// Tracer t's part of a per-tracer field of `size` entries a tracer (an
// absent optional output stays null).
template <typename T>
__device__ __forceinline__ T* at_tracer(T* p, int t, size_t size) {
  return p == nullptr ? p : p + (size_t)t * size;
}

// The tile of the node kernels (K1, K2, K12, K34, K4): nodes of one block,
// and the levels of one block of each.  ops/meshdata.py:TILE_NODES,
// LIMIT_LEVELS, LIMIT_FUSED_LEVELS and UPDATE_SPLIT_LEVELS are copies
// (tests/test_torch_kernels.py holds them equal, as it does for
// kMaxWideThreads and OccupancyKernel).
constexpr int kTileNodes = 32;
constexpr int kBoundsLevels = 32;
constexpr int kLimitLevels = 32;
constexpr int kLimitFusedLevels = 24;
constexpr int kUpdateLevels = 16;
constexpr int kUpdateSplitLevels = 32;
// K4's FIX form at one tracer (see update_kernel): shorter chunks share a
// part's halo edges among more blocks
constexpr int kFixLevels = 8;

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

// (toff: the tracer's offset into lo and ttf, 0 for a single tracer)
template <typename T, int MAXD>
__device__ __forceinline__ Level<T> cluster_level(
    const T* __restrict__ lo, const T* __restrict__ ttf, int z, int n,
    int N, int nlev, const int (&oth)[MAXD], const int (&lev)[MAXD],
    size_t toff = 0) {
  const T big = T(1e30);
  const size_t row = toff + (size_t)z * N;
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

// fct_ttf_max / fct_ttf_min (0 on inactive rows) of node-level (n, z) from
// the vlimit 1/2/3 window over levels z-1 (p*), z (cur) and z+1 (x*): the
// cluster bounds at z-1 and z+1, and a1's fct_ttf_max there for the vlimit
// 2/3 window (*a_hi in its max, *a_lo in its min: both a1max where the level
// exists, -big / +big above the surface and below the bottom).  Shared by K1
// and K12, so both compute the same bits.
template <typename T>
__device__ __forceinline__ void bounds_window(
    T pmax, T pmin, T pa_hi, T pa_lo, const Level<T>& cur, T xmax, T xmin,
    T xa_hi, T xa_lo, int z, int nlev, int vlimit, T& tx, T& tn) {
  const bool act = z < nlev - 1;
  const bool plain = (z == 0) || (z >= nlev - 2);
  T smax = cur.cmax, smin = cur.cmin;
  if (!plain) {
    if (vlimit == 1) {
      smax = vmax(vmax(pmax, cur.cmax), xmax);
      smin = vmin(vmin(pmin, cur.cmin), xmin);
    } else {
      // vlimit 2/3: both windows over a1's fct_ttf_max
      const T wmax = vmax(vmax(pa_hi, cur.a1max), xa_hi);
      const T wmin = vmin(vmin(pa_lo, cur.a1max), xa_lo);
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
}

// H-K1 on a tile of kTileNodes nodes x kBoundsLevels levels [z0, z0+LC).
// Replaces kernels.py:bounds_dia_dma_pallas (and bounds_pallas,
// bounds_dia_pallas: the same function).  Bound by its bytes on the H100
// (fct_LO and ttf read on active rows, the two bounds written: 90.5 MB on
// core2 f32, 0.027 ms at 3.35 TB/s).  The node-threaded form ran one
// thread per node down all 47 levels: 995 blocks of 128 on core2, 1.08
// waves at its 72 registers, and the last blocks ran their whole column on
// an idle card.  Here phase 1 computes each (node, level)'s cluster
// bounds, a1 and fct_LO for levels z0-1 .. z0+LC into shared memory (lane
// l holds node n0+l, so each warp's reads of one level are contiguous, and
// the node's incidence row is held in registers across the warp's levels);
// phase 2 applies the window to levels [z0, z0+LC) from there and writes
// both bounds coalesced.  The level either side is computed twice (by this
// chunk and its neighbour): 2/32 more gathers, for a grid of ceil(N/32) x
// ceil(L/32) blocks (7,954 on core2: 6 waves at 10 blocks an SM).  By
// ablation (utils/ablate.py, core2 f32 on an H100), the neighbour gathers
// of fct_LO and ttf take about 40% of the time; without them the kernel
// still runs at about 60% of its bound.
template <typename T, int MAXD, int THREADS, bool TRACERS>
__global__ void __launch_bounds__(THREADS, min_blocks(THREADS))
bounds_kernel(const T* __restrict__ lo, const T* __restrict__ ttf,
              const int* __restrict__ nd_other,
              const int* __restrict__ nd_lev,
              const int* __restrict__ nd_num,
              const int* __restrict__ nlev_nod, T* __restrict__ tmax_out,
              T* __restrict__ tmin_out, int L, int N, int KD, int vlimit,
              int Tb) {
  constexpr int kWarps = THREADS / kTileNodes;
  constexpr int LC = kBoundsLevels;
  // row r holds level z0 - 1 + r
  __shared__ T s_cmax[LC + 2][kTileNodes];
  __shared__ T s_cmin[LC + 2][kTileNodes];
  __shared__ T s_a1[LC + 2][kTileNodes];
  __shared__ T s_lo[LC + 2][kTileNodes];
  const TracerBlock tb = tracer_block<TRACERS>(Tb);
  const size_t toff = (size_t)tb.t * L * N;  // the tracer's fields
  const int lane = threadIdx.x % kTileNodes;
  const int warp = threadIdx.x / kTileNodes;
  const int n = tb.b * kTileNodes + lane;
  const int z0 = blockIdx.y * LC;
  const int nlev = n < N ? nlev_nod[n] : 0;
  if (n < N) {
    const int num = nd_num[n];
    int oth[MAXD], lev[MAXD];
#pragma unroll
    for (int k = 0; k < MAXD; ++k) {
      const bool ok = k < num;
      oth[k] = ok ? nd_other[(size_t)n * KD + k] : n;
      lev[k] = ok ? nd_lev[(size_t)n * KD + k] : 0;
    }
    for (int r = warp; r < LC + 2; r += kWarps) {
      const int z = z0 - 1 + r;
      if (z < 0 || z >= L) continue;
      const Level<T> c = cluster_level<T, MAXD>(lo, ttf, z, n, N, nlev, oth,
                                                lev, toff);
      s_cmax[r][lane] = c.cmax;
      s_cmin[r][lane] = c.cmin;
      s_a1[r][lane] = c.a1max;
      s_lo[r][lane] = c.lo;
    }
  }
  __syncthreads();
  if (n >= N) return;
  const T big = T(1e30);
  for (int r = 1 + warp; r <= LC; r += kWarps) {
    const int z = z0 - 1 + r;
    if (z >= L) break;
    const Level<T> cur{s_cmax[r][lane], s_cmin[r][lane], s_a1[r][lane],
                       s_lo[r][lane]};
    T pmax = -big, pmin = big, pa_hi = -big, pa_lo = big;
    if (z >= 1) {
      pmax = s_cmax[r - 1][lane];
      pmin = s_cmin[r - 1][lane];
      pa_hi = pa_lo = s_a1[r - 1][lane];
    }
    T xmax = -big, xmin = big, xa_hi = -big, xa_lo = big;
    if (z + 1 < L) {
      xmax = s_cmax[r + 1][lane];
      xmin = s_cmin[r + 1][lane];
      xa_hi = xa_lo = s_a1[r + 1][lane];
    }
    T tx, tn;
    bounds_window(pmax, pmin, pa_hi, pa_lo, cur, xmax, xmin, xa_hi, xa_lo, z,
                  nlev, vlimit, tx, tn);
    const size_t idx = toff + (size_t)z * N + n;
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
// where b2 uses them) and as K12 holds them (in registers).
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

// K2's factors at level z of node n (b1 vertical, b1 horizontal, b2) into
// fp / fm, from the bounds of that node and level (read only on active
// rows) and the vertical fluxes up (interface z) and dn (interface z+1).
// Bit k of first is set where incidence slot k is the edge's first
// endpoint.  idx indexes the shared rows (area_inv) at (z, n), erow starts
// the tracer's edge row z.  Shared by K2 and K12, so both compute the same
// bits.
template <typename T, int MAXD, typename Bounds>
__device__ __forceinline__ void limit_factors(
    const T* __restrict__ adf_h, const T* __restrict__ area_inv,
    const int (&eidx)[MAXD], const int (&lev)[MAXD], unsigned first, int z,
    size_t idx, size_t erow, bool act, const Bounds& bnd, T up, T dn, T dt,
    T eps, T& fp, T& fm) {
  // b1 vertical (kernels/fct_ale_b1_vertical.cu:13-14)
  const T pv = vmax(T(0), up) + vmax(T(0), -dn);
  const T mv = vmin(T(0), up) + vmin(T(0), -dn);
  // b1 horizontal: signed incident-edge fluxes
  T gp = T(0), gm = T(0);
#pragma unroll
  for (int k = 0; k < MAXD; ++k) {
    if (z < lev[k]) {
      const T f = adf_h[erow + eidx[k]];
      const T x = (first >> k) & 1u ? f : -f;
      gp += vmax(T(0), x);
      gm += vmin(T(0), x);
    }
  }
  // b2 (kernels/fct_ale_b2.cu:10-11)
  const T ai = area_inv[idx];
  const T fplus = (pv + gp) * dt * ai + eps;
  const T fminus = (mv + gm) * dt * ai - eps;
  fp = act ? vmin(T(1), bnd.max() / fplus) : T(0);
  fm = act ? vmin(T(1), bnd.min() / fminus) : T(0);
}

// b3 vertical (kernels/fct_ale_b3_vertical.cu:17-45) of the flux at
// interface z, from the factors of level z (fp, fm) and z-1 (fp_prev,
// fm_prev; 1 above z = 0), written at vidx.  Shared by K2 and K12.
template <typename T>
__device__ __forceinline__ void limit_vertical(
    T flux, T fp_prev, T fm_prev, T fp, T fm, bool act, int z, size_t vidx,
    T* __restrict__ adf_v_lim, T* __restrict__ adf_v_res) {
  const T ae_pos = vmin(T(1), vmin(fm_prev, fp));
  const T ae_neg = vmin(T(1), vmin(fp_prev, fm));
  const T ae = flux >= T(0) ? ae_pos : ae_neg;
  adf_v_lim[vidx] = act ? ae * flux : flux;
  if (adf_v_res != nullptr) {
    adf_v_res[vidx] = (act && z >= 1) ? (T(1) - ae) * flux : T(0);
  }
}

// The incidence rows of the tile of kTileNodes nodes from n0, one
// contiguous run of [N, KD], read coalesced into shared memory slot-major
// (lane l reads column l, no bank conflict); padding slots, and nodes past
// N, get level bound 0.  Shared by K2 and K4; visible after a barrier.
// OTHER (K4's FIX form) stages the slots' other endpoints (nd_other) into
// s_oth as a fourth row in the same pass.
template <int MAXD, int THREADS, bool OTHER = false>
__device__ __forceinline__ void stage_tile_rows(
    const int* __restrict__ nd_idx, const int* __restrict__ nd_lev,
    const signed char* __restrict__ nd_sgn, const int* __restrict__ nd_num,
    int n0, int N, int KD, int (&s_eidx)[MAXD][kTileNodes],
    int (&s_lev)[MAXD][kTileNodes], int (&s_sgn)[MAXD][kTileNodes],
    const int* __restrict__ nd_other = nullptr,
    int (*s_oth)[kTileNodes] = nullptr) {
  for (int w = threadIdx.x; w < MAXD * kTileNodes; w += THREADS) {
    const int l = w / MAXD, k = w - l * MAXD;
    const bool ok = n0 + l < N && k < KD && k < nd_num[n0 + l];
    const size_t g = (size_t)(n0 + l) * KD + k;
    s_eidx[k][l] = ok ? nd_idx[g] : 0;
    s_lev[k][l] = ok ? nd_lev[g] : 0;
    s_sgn[k][l] = ok ? nd_sgn[g] : 0;
    if constexpr (OTHER) s_oth[k][l] = ok ? nd_other[g] : 0;
  }
}

// H-K2 on a tile of kTileNodes nodes x kLimitLevels levels [z0, z0+LC).
// Bound by its bytes on the H100 (the fluxes, both bounds and area_inv
// read on active rows, the factors and the limited vertical flux written:
// 210.9 MB on core2 f32, 0.063 ms at 3.35 TB/s; 55.4 MB on a part of a
// 4-part core2 step).  A node-threaded form, one thread per node down all
// 47 levels, left a part of a sharded step with 254 blocks of 128 (0.24
// waves, 8 warps an SM), each thread a serial chain of 47 levels of
// gathers whose latency so few warps cannot hide: 16% of its bound there.
// Here, as in H-K12's phases B and C without its phase A, lane l of each
// warp holds node n0+l and the warps take the levels in turn, so a block's
// levels run in parallel:
//   * the tile's incidence rows are read coalesced into shared memory
//     (stage_tile_rows), and each level takes its slots from there;
//   * phase B: at levels z0-1 .. z0+LC-1, limit_factors (the bounds read
//     from memory); the chunk's own levels write both factors coalesced,
//     and every level keeps them in shared memory;
//   * phase C: b3v (limit_vertical) at the chunk's levels, the z-1 factors
//     from shared memory.  The last chunk passes the bottom interface row L
//     through.
// The level above the chunk is computed twice (by this chunk and the one
// above): 1/LC more edge gathers.  Chunks of 32 levels (core2's 47 as 32
// and 15, the deep, mostly inactive chunk the short one) ran faster on a
// part than 16, 24, 40 and 48, and as fast as the node-threaded form on
// the whole mesh (core2 f32 on an H100); rows in shared memory held the
// f32 kernel to 40 registers against 48 with rows in registers, for the
// same time on a part and less on the whole mesh.  The device functions
// are those of H-K12, and the factors of each level, the fluxes and the
// order of the sums are the node-threaded form's, so the outputs are its
// bits.
template <typename T, int MAXD, int THREADS, bool TRACERS>
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
             T eps, int Tb) {
  constexpr int kWarps = THREADS / kTileNodes;
  constexpr int LC = kLimitLevels;
  __shared__ int s_eidx[MAXD][kTileNodes];
  __shared__ int s_lev[MAXD][kTileNodes];
  __shared__ int s_sgn[MAXD][kTileNodes];
  // row r holds the factors of level z0 - 1 + r
  __shared__ T s_fp[LC + 1][kTileNodes];
  __shared__ T s_fm[LC + 1][kTileNodes];
  const TracerBlock tb = tracer_block<TRACERS>(Tb);
  const int tile = tb.b, chunk = blockIdx.y;
  // the tracer's first row of its node and edge fields ([Tb * L, N],
  // [Tb * L, Ed]) and of its interface fields ([Tb * (L+1), N])
  const int tl = tb.t * L, tv = tb.t * (L + 1);
  const int lane = threadIdx.x % kTileNodes;
  const int warp = threadIdx.x / kTileNodes;
  const int n = tile * kTileNodes + lane;
  const int z0 = chunk * LC;
  const bool node = n < N;
  const int nlev = node ? nlev_nod[n] : 0;
  stage_tile_rows<MAXD, THREADS>(nd_idx, nd_lev, nd_sgn, nd_num,
                                 tile * kTileNodes, N, KD, s_eidx, s_lev,
                                 s_sgn);
  __syncthreads();
  if (node) {
    for (int r = warp; r <= LC; r += kWarps) {
      const int z = z0 - 1 + r;
      if (z < 0) continue;
      if (z >= L) break;
      int eidx[MAXD], lev[MAXD];
      unsigned first = 0u;
#pragma unroll
      for (int k = 0; k < MAXD; ++k) {
        eidx[k] = s_eidx[k][lane];
        lev[k] = s_lev[k][lane];
        if (s_sgn[k][lane] > 0) first |= 1u << k;
      }
      const size_t tidx = (size_t)(tl + z) * N + n;
      const size_t vidx = (size_t)(tv + z) * N + n;
      T fp, fm;
      limit_factors<T, MAXD>(adf_h, area_inv, eidx, lev, first, z,
                             (size_t)z * N + n, (size_t)(tl + z) * Ed,
                             z < nlev - 1,
                             BoundsInMemory<T>{tmax, tmin, tidx}, adf_v[vidx],
                             adf_v[vidx + N], dt, eps, fp, fm);
      s_fp[r][lane] = fp;
      s_fm[r][lane] = fm;
      if (r >= 1) {  // the chunk's own level
        plus_out[tidx] = fp;
        minus_out[tidx] = fm;
      }
    }
  }
  __syncthreads();
  if (!node) return;

  for (int r = 1 + warp; r <= LC; r += kWarps) {
    const int z = z0 - 1 + r;
    if (z >= L) break;
    const size_t vidx = (size_t)(tv + z) * N + n;
    T fp_prev = T(1), fm_prev = T(1);  // 1 above z = 0
    if (z >= 1) {
      fp_prev = s_fp[r - 1][lane];
      fm_prev = s_fm[r - 1][lane];
    }
    limit_vertical(adf_v[vidx], fp_prev, fm_prev, s_fp[r][lane],
                   s_fm[r][lane], z < nlev - 1, z, vidx, adf_v_lim,
                   adf_v_res);
    if (z == L - 1) {
      const size_t last = vidx + N;
      adf_v_lim[last] = adf_v[last];
      if (adf_v_res != nullptr) adf_v_res[last] = T(0);
    }
  }
}

// ---------------------------------------------------------------------------
// H-K12 limit_fused.  Replaces kernels_packed.py:limit_fused_pallas (the
// computation of _limit_fused_kernel): K1 (a1, the cluster bounds, the
// vlimit window, "- fct_LO") and K2 (b1v, b1h, b2, b3v) in one launch on a
// tile of kTileNodes nodes x kLimitFusedLevels levels [z0, z0+LC).  It
// saves the write and re-read of fct_ttf_max/min through device memory
// (the bounds are still written once, as outputs of the step) and one
// launch: 261.8 MB on core2 f32 against K1's 90.5 + K2's 210.9, 0.078 ms
// at 3.35 TB/s.  b3v follows the oracle's mask z < nlev_nod - 1, as K2
// does; the Pallas kernel calls _limit_body, whose mask is z < nlev_nod
// (ROADMAP Queue C).
//
// A thread that held both incidence rows (nd_other for K1, nd_idx for K2)
// and K1's three-level window at once would need over 100 registers and
// leave few blocks an SM.  So the block runs three phases, each with one
// row live, and passes what the levels share through shared memory:
//   * phase A: lane l of each warp computes node n0+l's cluster bounds and
//     a1 (cluster_level, nd_other and nd_lev live) at levels z0-2 ..
//     z0+LC into shared memory.  b3v at z0 needs K2's factors at z0-1,
//     those need the bounds at z0-1, and those the cluster at z0-2: one
//     level more above the chunk than K1 computes;
//   * phase B: at levels z0-1 .. z0+LC-1 the window (bounds_window) from
//     the shared rows and the node's own fct_LO, then K2's factors
//     (limit_factors, nd_idx, nd_lev and the first-endpoint bits live) from
//     those bounds, which stay in the thread's registers (the warp that
//     computes a level's bounds computes its factors too).  The chunk's own
//     levels write both bounds and both factors coalesced; every level
//     keeps its factors in shared memory;
//   * phase C: b3v (limit_vertical) at the chunk's levels, its z-1 factors
//     from shared memory.  The last chunk passes the bottom interface row L
//     through, as K2 does.
// The grid is ceil(N/32) x ceil(L/24) blocks (7,954 on core2, chunks of 24
// and 23 levels).  The levels above the chunk are computed twice (by this
// chunk and the one above): 1/24 more edge gathers and 3/24 more cluster
// gathers.  On core2 f32 (an H100) chunks of 24 beat 16 (more recompute)
// and 32 (chunks of 32 and 15), and phase B reading the node's fct_LO from
// memory beat a fourth shared row (16.8 KB a block against 20.2 KB at f32,
// which leaves the gathers more L1).  The device functions are K1's and
// K2's, so the outputs are the bits of K1 -> K2.
// ---------------------------------------------------------------------------

template <typename T, int MAXD, int THREADS, bool TRACERS>
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
                   int L, int N, int Ed, int KD, int vlimit, T dt, T eps,
                   int Tb) {
  constexpr int kWarps = THREADS / kTileNodes;
  constexpr int LC = kLimitFusedLevels;
  // phase A: row r holds level z0 - 2 + r
  __shared__ T s_cmax[LC + 3][kTileNodes];
  __shared__ T s_cmin[LC + 3][kTileNodes];
  __shared__ T s_a1[LC + 3][kTileNodes];
  // phase B: row r holds K2's factors at level z0 - 1 + r
  __shared__ T s_fp[LC + 1][kTileNodes];
  __shared__ T s_fm[LC + 1][kTileNodes];
  const TracerBlock tb = tracer_block<TRACERS>(Tb);
  if constexpr (TRACERS) {
    // the tracer's fields (see the note at the top)
    const size_t nodes = (size_t)L * N, ifaces = nodes + N;
    const size_t edges = (size_t)L * Ed;
    lo = at_tracer(lo, tb.t, nodes);
    ttf = at_tracer(ttf, tb.t, nodes);
    adf_v = at_tracer(adf_v, tb.t, ifaces);
    adf_h = at_tracer(adf_h, tb.t, edges);
    tmax_out = at_tracer(tmax_out, tb.t, nodes);
    tmin_out = at_tracer(tmin_out, tb.t, nodes);
    plus_out = at_tracer(plus_out, tb.t, nodes);
    minus_out = at_tracer(minus_out, tb.t, nodes);
    adf_v_lim = at_tracer(adf_v_lim, tb.t, ifaces);
    adf_v_res = at_tracer(adf_v_res, tb.t, ifaces);
  }
  const int lane = threadIdx.x % kTileNodes;
  const int warp = threadIdx.x / kTileNodes;
  const int n = tb.b * kTileNodes + lane;
  const int z0 = blockIdx.y * LC;
  const bool node = n < N;
  const int nlev = node ? nlev_nod[n] : 0;
  const int num = node ? nd_num[n] : 0;
  int lev[MAXD];  // 0 on padding slots, live in phases A and B
#pragma unroll
  for (int k = 0; k < MAXD; ++k)
    lev[k] = k < num ? nd_lev[(size_t)n * KD + k] : 0;

  if (node) {
    int oth[MAXD];
#pragma unroll
    for (int k = 0; k < MAXD; ++k)
      oth[k] = k < num ? nd_other[(size_t)n * KD + k] : n;
    for (int r = warp; r < LC + 3; r += kWarps) {
      const int z = z0 - 2 + r;
      if (z < 0 || z >= L) continue;
      const Level<T> c = cluster_level<T, MAXD>(lo, ttf, z, n, N, nlev, oth,
                                                lev);
      s_cmax[r][lane] = c.cmax;
      s_cmin[r][lane] = c.cmin;
      s_a1[r][lane] = c.a1max;
    }
  }
  __syncthreads();

  if (node) {
    int eidx[MAXD];
    unsigned first = 0u;
#pragma unroll
    for (int k = 0; k < MAXD; ++k) {
      const bool ok = k < num;
      eidx[k] = ok ? nd_idx[(size_t)n * KD + k] : 0;
      if (ok && nd_sgn[(size_t)n * KD + k] > 0) first |= 1u << k;
    }
    const T big = T(1e30);
    for (int r = warp; r <= LC; r += kWarps) {
      const int z = z0 - 1 + r;
      if (z < 0) continue;
      if (z >= L) break;
      const int c = r + 1;  // level z's row of phase A
      const size_t idx = (size_t)z * N + n;
      const Level<T> cur{s_cmax[c][lane], s_cmin[c][lane], s_a1[c][lane],
                         lo[idx]};
      T pmax = -big, pmin = big, pa_hi = -big, pa_lo = big;
      if (z >= 1) {
        pmax = s_cmax[c - 1][lane];
        pmin = s_cmin[c - 1][lane];
        pa_hi = pa_lo = s_a1[c - 1][lane];
      }
      T xmax = -big, xmin = big, xa_hi = -big, xa_lo = big;
      if (z + 1 < L) {
        xmax = s_cmax[c + 1][lane];
        xmin = s_cmin[c + 1][lane];
        xa_hi = xa_lo = s_a1[c + 1][lane];
      }
      T tx, tn;
      bounds_window(pmax, pmin, pa_hi, pa_lo, cur, xmax, xmin, xa_hi, xa_lo,
                    z, nlev, vlimit, tx, tn);
      T fp, fm;
      limit_factors<T, MAXD>(adf_h, area_inv, eidx, lev, first, z, idx,
                             (size_t)z * Ed, z < nlev - 1,
                             BoundsInRegisters<T>{tx, tn}, adf_v[idx],
                             adf_v[idx + N], dt, eps, fp, fm);
      s_fp[r][lane] = fp;
      s_fm[r][lane] = fm;
      if (r >= 1) {  // the chunk's own level
        tmax_out[idx] = tx;
        tmin_out[idx] = tn;
        plus_out[idx] = fp;
        minus_out[idx] = fm;
      }
    }
  }
  __syncthreads();
  if (!node) return;

  for (int r = 1 + warp; r <= LC; r += kWarps) {
    const int z = z0 - 1 + r;
    if (z >= L) break;
    const size_t vidx = (size_t)z * N + n;
    T fp_prev = T(1), fm_prev = T(1);  // 1 above z = 0
    if (z >= 1) {
      fp_prev = s_fp[r - 1][lane];
      fm_prev = s_fm[r - 1][lane];
    }
    limit_vertical(adf_v[vidx], fp_prev, fm_prev, s_fp[r][lane],
                   s_fm[r][lane], z < nlev - 1, z, vidx, adf_v_lim,
                   adf_v_res);
    if (z == L - 1) {
      // the bottom interface row, one index spelt two ways: with vidx + N
      // ptxas schedules phase B's loads of the instance with the tracer
      // axis better (H-K12 at Tb = 2 11% faster in f32, 2% in f64, core2
      // on an H100), while L * N + n keeps the Tb = 1 instance the code it
      // had before the axis (against vidx + N there: 3% faster in f32, 5%
      // slower in f64)
      const size_t last = TRACERS ? vidx + N : (size_t)L * N + n;
      adf_v_lim[last] = adf_v[last];
      if (adf_v_res != nullptr) adf_v_res[last] = T(0);
    }
  }
}

// ---------------------------------------------------------------------------
// Stage c (docs/refactoring.md:269-314) at a node and level, from the signed
// sum acc of its limited incident edge fluxes and its limited vertical
// fluxes up (interface z) and dn (interface z+1): idx indexes the shared
// rows (hnode, hnode_new, area_inv), tidx the tracer's node fields (the
// same for a single tracer).  Shared by K34 and K4.
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ void stage_c(
    const T* __restrict__ ttf, const T* __restrict__ hnode,
    const T* __restrict__ hnode_new, const T* __restrict__ lo,
    const T* __restrict__ dvin, const T* __restrict__ dhin,
    const T* __restrict__ area_inv, T* __restrict__ o1, T* __restrict__ o2,
    size_t idx, size_t tidx, bool act, T up, T dn, T acc, T dt,
    int iter_yn) {
  const T ai = area_inv[idx];
  const T ddiv = (up - dn) * dt * ai;
  const T dh = acc * dt * ai;
  const T l = lo[tidx];
  if (iter_yn) {
    const T hnn = hnode_new[idx];
    o1[tidx] = (act ? l + ddiv / hnn : l) + dh / hnn;
  } else {
    const T dv = -ttf[tidx] * hnode[idx] + l * hnode_new[idx] + ddiv;
    const T d = dvin[tidx];
    o1[tidx] = act ? d + dv : d;
    o2[tidx] = dhin[tidx] + dh;
  }
}

// ---------------------------------------------------------------------------
// b3 horizontal (kernels/fct_ale_b3_horizontal.cu:28-39), shared by K3,
// K3fix and K34: the limiter of one edge at one level from the factors of
// its first (p1, m1) and second (p2, m2) endpoint,
//   ae = min(1, min(p1, m2)) if f >= 0 else min(1, min(m1, p2)),
// the limited flux ae * f and the residual (1 - ae) * f on active levels
// (z < nlev_edge), f and 0 elsewhere.
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ T edge_limiter(T f, T p1, T m1, T p2, T m2) {
  const T ae_pos = vmin(T(1), vmin(p1, m2));
  const T ae_neg = vmin(T(1), vmin(m1, p2));
  return f >= T(0) ? ae_pos : ae_neg;
}

// Edge e at level z: both outputs written, the limited flux returned.
template <typename T>
__device__ __forceinline__ T b3h_edge(
    const T* __restrict__ plus, const T* __restrict__ minus,
    const T* __restrict__ adf_h, const int* __restrict__ edges,
    const int* __restrict__ nlev_edge, T* __restrict__ adf_h_lim,
    T* __restrict__ adf_h_res, int z, int e, int N, int Ed) {
  const size_t idx = (size_t)z * Ed + e;
  const T f = adf_h[idx];
  T lim = f, res = T(0);
  if (z < nlev_edge[e]) {
    const size_t row = (size_t)z * N;
    const int n1 = edges[2 * (size_t)e];
    const int n2 = edges[2 * (size_t)e + 1];
    const T ae = edge_limiter(f, plus[row + n1], minus[row + n1],
                              plus[row + n2], minus[row + n2]);
    lim = mul_rn(ae, f);
    res = (T(1) - ae) * f;
  }
  adf_h_lim[idx] = lim;
  if (adf_h_res != nullptr) adf_h_res[idx] = res;
  return lim;
}

// ---------------------------------------------------------------------------
// H-K34 update_fused.  Replaces kernels_packed.py:update_fused_pallas (the
// computation of _update_fused_kernel): b3 horizontal limiting of every
// edge, the signed sum of each node's limited incident fluxes (c_update_
// solution / c_update_LO) and stage c.
//
// Bound by its bytes on the H100: the node fields of stage c, both
// factors, the flux read and the limited flux (and residual) written, 392
// MB on core2 f32 (0.117 ms at 3.35 TB/s).  The node-threaded form ran one
// thread per node down all 47 levels (995 blocks of 128 on core2, 1.26
// waves at its 80 registers) and wrote each edge output from a node thread
// at nd_idx addresses, about 3 edges apart across a warp: each store
// instruction touched about three times the sectors it filled.
//
// Here a block takes a tile of kTileNodes nodes [n0, n1) and kUpdateLevels
// levels (11,931 blocks on core2: 9 waves at 10 blocks an SM).  Edges are
// sorted by their first endpoint, so the edges that start in the tile are
// the range [ed_ptr[n0], ed_ptr[n1]) (the last tile also passes the
// padding edges of a part, after ed_ptr[N], through).
//   * Edge phase: one thread per (edge, level) of that range, consecutive
//     threads on consecutive edges of one level, as K3 (b3h_edge): both
//     outputs are written coalesced, and each limited flux is kept in
//     shared memory (tile_edges of them a level, sized on the host from the
//     largest tile).  Every edge is written by exactly one block, also an
//     edge from a part's low-side halo column to an owned node.
//   * Node phase, after __syncthreads: lane l of each warp sums node n0+l's
//     incident fluxes at the warp's levels, in slot order with K4's signs.
//     An edge of the tile's range comes from shared memory; one that starts
//     in an earlier tile is limited again from fct_plus / fct_minus, with
//     b3h_edge's expression.  Then stage c.  The tile's incidence rows are
//     staged in shared memory and read there per slot, which holds the
//     kernel to 48 registers (f32, 8 slots); rows held in registers nearly
//     doubled that and halved the blocks an SM.
// Each limited flux is rounded on its own (mul_rn) and summed in K4's
// order, so the results are bit-identical to K3 -> K4's.  A mesh whose
// neighbours lie far apart in the numbering has most edges cross a tile
// (core2: 68%, neighbours 303 nodes apart against 32-node tiles).  By
// ablation (utils/ablate.py, core2 f32 on an H100) the node phase's
// gather of those edges, one scattered value per slot and level, takes
// about 40% of the time; limiting them again costs about 2% over reading
// them back.
template <typename T, int MAXD, int THREADS, bool TRACERS>
__global__ void __launch_bounds__(THREADS, min_blocks(THREADS))
update_fused_kernel(const T* __restrict__ plus, const T* __restrict__ minus,
                    const T* __restrict__ adf_v_lim,
                    const T* __restrict__ adf_h, const T* __restrict__ ttf,
                    const T* __restrict__ hnode,
                    const T* __restrict__ hnode_new,
                    const T* __restrict__ lo, const T* __restrict__ dvin,
                    const T* __restrict__ dhin,
                    const T* __restrict__ area_inv,
                    const int* __restrict__ edges,
                    const int* __restrict__ nlev_edge,
                    const int* __restrict__ ed_ptr,
                    const int* __restrict__ nd_idx,
                    const int* __restrict__ nd_other,
                    const int* __restrict__ nd_lev,
                    const signed char* __restrict__ nd_sgn,
                    const int* __restrict__ nd_num,
                    const int* __restrict__ nlev_nod, T* __restrict__ o1,
                    T* __restrict__ o2, T* __restrict__ adf_h_lim,
                    T* __restrict__ adf_h_res, int L, int N, int Ed, int KD,
                    int tile_edges, T dt, int iter_yn, int Tb) {
  constexpr int kWarps = THREADS / kTileNodes;
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_lim = reinterpret_cast<T*>(smem);  // [levels][ns]
  // the tile's incidence rows, slot-major (lane l reads column l, no bank
  // conflict); padding slots have level bound 0
  __shared__ int s_eidx[MAXD][kTileNodes];
  __shared__ int s_oth[MAXD][kTileNodes];
  __shared__ int s_lev[MAXD][kTileNodes];
  __shared__ int s_sgn[MAXD][kTileNodes];
  const TracerBlock tb = tracer_block<TRACERS>(Tb);
  if constexpr (TRACERS) {
    const size_t node = (size_t)L * N, edge = (size_t)L * Ed;
    plus = at_tracer(plus, tb.t, node);
    minus = at_tracer(minus, tb.t, node);
    adf_v_lim = at_tracer(adf_v_lim, tb.t, node + N);
    adf_h = at_tracer(adf_h, tb.t, edge);
    ttf = at_tracer(ttf, tb.t, node);
    lo = at_tracer(lo, tb.t, node);
    dvin = at_tracer(dvin, tb.t, node);
    dhin = at_tracer(dhin, tb.t, node);
    o1 = at_tracer(o1, tb.t, node);
    o2 = at_tracer(o2, tb.t, node);
    adf_h_lim = at_tracer(adf_h_lim, tb.t, edge);
    adf_h_res = at_tracer(adf_h_res, tb.t, edge);
  }
  const int n0 = tb.b * kTileNodes;
  const int n1 = min(n0 + kTileNodes, N);
  const int z0 = blockIdx.y * kUpdateLevels;
  const int nz = min(kUpdateLevels, L - z0);
  const int e0 = ed_ptr[n0];
  const int e1 = ed_ptr[n1];
  const int ne = (n1 == N ? Ed : e1) - e0;  // edges this block writes
  const int ns = min(e1 - e0, tile_edges);  // edges kept in shared memory
  // the rows of the tile's nodes are one contiguous run of [N, KD]: read
  // coalesced once per block (visible after the edge phase's barrier)
  for (int w = threadIdx.x; w < MAXD * kTileNodes; w += THREADS) {
    const int l = w / MAXD, k = w - l * MAXD;
    const bool ok = n0 + l < N && k < KD && k < nd_num[n0 + l];
    const size_t g = (size_t)(n0 + l) * KD + k;
    s_eidx[k][l] = ok ? nd_idx[g] : 0;
    s_oth[k][l] = ok ? nd_other[g] : 0;
    s_lev[k][l] = ok ? nd_lev[g] : 0;
    s_sgn[k][l] = ok ? nd_sgn[g] : 0;
  }
  for (int i = threadIdx.x; i < ne * nz; i += THREADS) {
    const int r = i / ne;
    const int j = i - r * ne;
    const T lim = b3h_edge(plus, minus, adf_h, edges, nlev_edge, adf_h_lim,
                           adf_h_res, z0 + r, e0 + j, N, Ed);
    if (j < ns) s_lim[r * ns + j] = lim;
  }
  __syncthreads();

  const int lane = threadIdx.x % kTileNodes;
  const int n = n0 + lane;
  if (n >= N) return;
  const int nlev = nlev_nod[n];
  for (int r = threadIdx.x / kTileNodes; r < nz; r += kWarps) {
    const int z = z0 + r;
    const size_t row = (size_t)z * N;
    const size_t idx = row + n;
    T acc = T(0);
#pragma unroll
    for (int k = 0; k < MAXD; ++k) {
      if (z < s_lev[k][lane]) {
        const int e = s_eidx[k][lane];
        const bool first = s_sgn[k][lane] > 0;
        const int j = e - e0;
        T lim;
        if ((unsigned)j < (unsigned)ns) {
          lim = s_lim[r * ns + j];
        } else {
          const int o = s_oth[k][lane];
          const T f = adf_h[(size_t)z * Ed + e];
          const T pn = plus[idx], mn = minus[idx];
          const T po = plus[row + o], mo = minus[row + o];
          const T ae = first ? edge_limiter(f, pn, mn, po, mo)
                             : edge_limiter(f, po, mo, pn, mn);
          lim = mul_rn(ae, f);
        }
        acc += first ? lim : -lim;
      }
    }
    stage_c(ttf, hnode, hnode_new, lo, dvin, dhin, area_inv, o1, o2, idx,
            idx, z < nlev - 1, adf_v_lim[idx], adf_v_lim[idx + N], acc, dt,
            iter_yn);
  }
}

// ---------------------------------------------------------------------------
// H-K3 b3h and H-K3fix b3h_fixup.  Replace kernels_packed.py:
// b3h_packed_pallas / kernels.py:b3h_pallas (the split K3) and
// kernels_packed.py:b3h_packed_fixup_pallas / kernels.py:b3h_fixup_pallas
// (its post-exchange fixup): b3h_edge for one edge at one level.  K3 covers
// every edge; K3fix only the edges of an id list (those that touch a halo
// node), writing in place into K3's outputs.  A duplicated id rewrites the
// same values.  Where the TPU kernels gather both endpoints' factors
// through one-hot contractions or packed pair shifts, each thread here
// reads them directly; the reads of one level fall within a few node rows
// of each other.
// ---------------------------------------------------------------------------

template <typename T, int THREADS, bool TRACERS>
__global__ void __launch_bounds__(THREADS, min_blocks(THREADS))
b3h_kernel(const T* __restrict__ plus, const T* __restrict__ minus,
           const T* __restrict__ adf_h, const int* __restrict__ edges,
           const int* __restrict__ nlev_edge, T* __restrict__ adf_h_lim,
           T* __restrict__ adf_h_res, int L, int N, int Ed, int Tb) {
  const TracerBlock tb = tracer_block<TRACERS>(Tb);
  const int e = tb.b * blockDim.x + threadIdx.x;
  if (e >= Ed) return;
  const size_t node = (size_t)L * N, edge = (size_t)L * Ed;
  b3h_edge(at_tracer(plus, tb.t, node), at_tracer(minus, tb.t, node),
           at_tracer(adf_h, tb.t, edge), edges, nlev_edge,
           at_tracer(adf_h_lim, tb.t, edge), at_tracer(adf_h_res, tb.t, edge),
           (int)blockIdx.y, e, N, Ed);
}

template <typename T, int THREADS, bool TRACERS>
__global__ void __launch_bounds__(THREADS, min_blocks(THREADS))
b3h_fixup_kernel(const T* __restrict__ plus, const T* __restrict__ minus,
                 const T* __restrict__ adf_h, const int* __restrict__ edges,
                 const int* __restrict__ nlev_edge,
                 const int* __restrict__ ids, T* __restrict__ adf_h_lim,
                 T* __restrict__ adf_h_res, int L, int N, int Ed, int n_ids,
                 int Tb) {
  const TracerBlock tb = tracer_block<TRACERS>(Tb);
  const int i = tb.b * blockDim.x + threadIdx.x;
  if (i >= n_ids) return;
  const int e = ids[i];
  // ids come from the part's own edges (step_sharded.fix_edge_ids); an id
  // out of range must still not write outside the edge arrays
  if (e < 0 || e >= Ed) return;
  const size_t node = (size_t)L * N, edge = (size_t)L * Ed;
  b3h_edge(at_tracer(plus, tb.t, node), at_tracer(minus, tb.t, node),
           at_tracer(adf_h, tb.t, edge), edges, nlev_edge,
           at_tracer(adf_h_lim, tb.t, edge), at_tracer(adf_h_res, tb.t, edge),
           (int)blockIdx.y, e, N, Ed);
}

// ---------------------------------------------------------------------------
// H-K4 update.  Replaces kernels_packed.py:update_packed_pallas and
// kernels.py:update_pallas (the split K4): stage c from edge fluxes that
// are already limited.  K34's node phase without the limiting: the signed
// sum of the limited fluxes over the node's incidence slots in slot order,
// then stage_c.  It reads one edge value per slot and level where K34
// reads the flux and the other endpoint's two factors.
//
// Bound by its bytes on the H100: the node fields of stage c, both
// vertical interfaces and the limited edge flux of each live slot read,
// one or two outputs written (263.7 MB on core2 f32, 0.079 ms at 3.35
// TB/s; 69.7 MB on a part of a 4-part core2 step).  A node-threaded form,
// one thread per node down all 47 levels, left a part with 254 blocks of
// 128 (0.21 waves, 8 warps an SM), each thread a serial chain of 47
// levels, each waiting on its slots' gathers: 29% of its bound there.
// Here a block takes a tile of kTileNodes nodes [n0, n0+32) and
// kUpdateSplitLevels levels, as H-K34's node phase does: the tile's
// incidence rows are read coalesced once into shared memory
// (stage_tile_rows), then lane l of each warp sums node n0+l's fluxes at
// the warp's levels and applies stage c, with up and dn read from the
// limited vertical flux at interfaces z and z+1.  Nothing carries from one
// level to the next, so every (node, level) is independent.  Chunks of 32
// levels ran faster on the whole mesh than 8, 12, 16 and 24, and at least
// as fast on a part (core2 f32 on an H100); warps that each take a run of
// consecutive levels and carry up from one to the next ran slower.  (Each
// chunk reads the tile's rows again, and more chunks read them more
// often.)  The slot order,
// the signs and stage_c are the node-threaded form's, so the outputs are
// its bits, and H-K34 still gives the bits of H-K3 -> H-K4.
//
// The FIX form (template flag FIX; the split step's only K4) also does
// K3fix's work, in place of its launch.  Replaces, with the plain form,
// kernels.py:b3h_fixup_pallas and kernels_packed.py:b3h_packed_fixup_pallas
// on a part of a sharded step.  K3fix ran 1,210 ids x 47 levels on core2's
// part 1 of 4 (about 470 blocks, under one wave) in 0.0035 ms against a
// 0.0002 ms bound on an H100: a launch's fixed cost and one round of
// scattered loads, and a wrapper call of host time on a host-bound step.
// On a part the incidence rows of halo columns are empty
// (parallel/partition.py), every local edge has an owned endpoint, and an
// edge that touches a halo column has exactly one, so it appears in exactly
// one row: that of its owned endpoint.  So the thread of that node limits
// such an edge (its other endpoint outside the owned columns [col_lo,
// col_hi)) again at each of its levels, from the exchanged factors, with
// b3h_edge's expression oriented by the slot's sign as K34's crossing
// edges are, and writes it (and its residual) over K3's value; no other
// thread reads that value.  Only live slots (z < the edge's levels) are
// written: on the others K3 wrote f and 0, which no factor changes.  Then
// the plain form's sum reads every slot back through the pointer it wrote
// by, in slot order, and stage c follows.  The wrapper holds the contract:
// every node with a non-empty row lies in [col_lo, col_hi).  The limited
// flux is rounded on its own (mul_rn), as b3h_edge's, so the outputs are
// the bits of K3fix -> K4.
//
// What bounds it on a part: the halo edges are a small share of a part's
// edges, but all sit in the tiles next to the halo, so those few blocks
// carry K3fix's whole latency chain, and any code for them costs
// registers in every block.  Variants timed beside each other on an H100
// (core2 f32; verdicts only, the scratch harness is not kept): limiting
// them inside the slot loop, one branch per slot, serialised every node's
// loads; gathering the slots first, or a halo pass with its slots
// unrolled, raised the registers past the 48 of 10 blocks an SM and lost
// time even on a mesh without a halo edge; a block-wide pass over a shared
// list of the tile's halo slots kept K4's registers but ran slower on a
// part.  This form, a per-thread pass over the set bits of the node's halo
// mask before the plain sum (levels unrolled by 2), keeps K4's registers
// and was the fastest of those that do.  At one tracer, chunks of
// kFixLevels = 8 levels (4 and 12 ran slower, 32 slower still) share the
// halo work among more blocks, and the tiles next to the halo start
// first; with the tracer axis every tile already has Tb blocks, and K4's
// chunks of 32 in tile order ran faster (Tb = 8).  At one tracer it runs
// slower than K4 on a whole mesh (every column owned, no halo edge): the
// short chunks suit a part only.  In the plain form (FIX false) the
// extra parameters are unused and every FIX branch folds away at compile
// time, so it compiles to the code it had before the flag (utils/sass.py
// checks it).  Each form has its instances with and without the tracer
// axis.
// ---------------------------------------------------------------------------

template <typename T, int MAXD, int THREADS, bool TRACERS, bool FIX>
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
              int iter_yn, int Tb,
              // FIX only: the exchanged factors, the raw flux, the other
              // endpoints, K3's outputs to write the halo edges into (the
              // array behind adf_h_lim, and the residual or null) and the
              // owned columns
              const T* __restrict__ plus, const T* __restrict__ minus,
              const T* __restrict__ adf_h,
              const int* __restrict__ nd_other, T* __restrict__ lim_out,
              T* __restrict__ res_out, int col_lo, int col_hi) {
  constexpr int kWarps = THREADS / kTileNodes;
  constexpr int LC = FIX && !TRACERS ? kFixLevels : kUpdateSplitLevels;
  __shared__ int s_eidx[MAXD][kTileNodes];
  __shared__ int s_lev[MAXD][kTileNodes];
  __shared__ int s_sgn[MAXD][kTileNodes];
  __shared__ int s_oth[FIX ? MAXD : 1][kTileNodes];  // FIX only
  const TracerBlock tb = tracer_block<TRACERS>(Tb);
  int tile = tb.b;
  if constexpr (FIX && !TRACERS) {
    // the tiles from both ends of the part inwards (0, last, 1, last - 1,
    // ...): the halo lies on both sides of a part's owned columns, so the
    // tiles next to it, which carry its edges, start first
    const int last = (N + kTileNodes - 1) / kTileNodes - 1;
    tile = (tb.b & 1u) ? last - (int)(tb.b >> 1) : (int)(tb.b >> 1);
  }
  const int chunk = blockIdx.y;
  // the tracer's first row of its node and edge fields and of its
  // interface fields, as in K2
  const int tl = tb.t * L, tv = tb.t * (L + 1);
  stage_tile_rows<MAXD, THREADS, FIX>(nd_idx, nd_lev, nd_sgn, nd_num,
                                      tile * kTileNodes, N, KD, s_eidx,
                                      s_lev, s_sgn, nd_other, s_oth);
  __syncthreads();
  const int lane = threadIdx.x % kTileNodes;
  const int n = tile * kTileNodes + lane;
  if (n >= N) return;
  const int nlev = nlev_nod[n];
  const int z1 = min((chunk + 1) * LC, L);
  if constexpr (!FIX) {
    for (int z = chunk * LC + threadIdx.x / kTileNodes; z < z1;
         z += kWarps) {
      const size_t erow = (size_t)(tl + z) * Ed;
      T acc = T(0);
#pragma unroll
      for (int k = 0; k < MAXD; ++k) {
        if (z < s_lev[k][lane]) {
          const T f = adf_h_lim[erow + s_eidx[k][lane]];
          acc += s_sgn[k][lane] > 0 ? f : -f;
        }
      }
      const size_t vidx = (size_t)(tv + z) * N + n;
      stage_c(ttf, hnode, hnode_new, lo, dvin, dhin, area_inv, o1, o2,
              (size_t)z * N + n, (size_t)(tl + z) * N + n, z < nlev - 1,
              adf_v_lim[vidx], adf_v_lim[vidx + N], acc, dt, iter_yn);
    }
  } else {
    // the node's live slots whose other endpoint is not owned (none on
    // most nodes: only those next to the halo have any)
    unsigned halo = 0u;
#pragma unroll
    for (int k = 0; k < MAXD; ++k) {
      const int o = s_oth[k][lane];
      if (s_lev[k][lane] > 0 &&
          (unsigned)(o - col_lo) >= (unsigned)(col_hi - col_lo))
        halo |= 1u << k;
    }
    const int z0 = chunk * LC + threadIdx.x / kTileNodes;
    if (halo != 0u) {
      // a node next to the halo: its halo edges limited again at each of
      // the thread's levels and written over K3's values, before the sum
      // below reads them back (the same thread and pointer: program order)
#pragma unroll 2
      for (int z = z0; z < z1; z += kWarps) {
        const size_t erow = (size_t)(tl + z) * Ed;
        const size_t row = (size_t)(tl + z) * N;
        const T pn = plus[row + n], mn = minus[row + n];
#pragma unroll 1
        for (unsigned h = halo; h != 0u; h &= h - 1u) {
          const int k = __ffs(h) - 1;
          if (z < s_lev[k][lane]) {
            const size_t ei = erow + s_eidx[k][lane];
            const int o = s_oth[k][lane];
            const T fl = adf_h[ei];
            const T po = plus[row + o], mo = minus[row + o];
            const T ae = s_sgn[k][lane] > 0
                             ? edge_limiter(fl, pn, mn, po, mo)
                             : edge_limiter(fl, po, mo, pn, mn);
            lim_out[ei] = mul_rn(ae, fl);
            if (res_out != nullptr) res_out[ei] = (T(1) - ae) * fl;
          }
        }
      }
    }
    // The plain form's sum and stage c, reading through lim_out, in one
    // loop for each iter_yn fixed at compile time.  With iter_yn a
    // run-time value in this kernel, the non-iterative stage c rounded
    // (up - dn) * dt * area_inv on its own before adding it, where the
    // plain form contracts it into one FMA with the sum (seen on an H100:
    // 1-ulp differences in del_ttf_advvert); with the branch gone both
    // forms contract alike and give the same bits.
    auto levels = [&](auto iter) {
      for (int z = z0; z < z1; z += kWarps) {
        const size_t erow = (size_t)(tl + z) * Ed;
        T acc = T(0);
#pragma unroll
        for (int k = 0; k < MAXD; ++k) {
          if (z < s_lev[k][lane]) {
            const T f = lim_out[erow + s_eidx[k][lane]];
            acc += s_sgn[k][lane] > 0 ? f : -f;
          }
        }
        const size_t vidx = (size_t)(tv + z) * N + n;
        stage_c(ttf, hnode, hnode_new, lo, dvin, dhin, area_inv, o1, o2,
                (size_t)z * N + n, (size_t)(tl + z) * N + n, z < nlev - 1,
                adf_v_lim[vidx], adf_v_lim[vidx + N], acc, dt,
                (int)decltype(iter)::value);
      }
    };
    if (iter_yn) {
      levels(std::true_type{});
    } else {
      levels(std::false_type{});
    }
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

// Every grid below has Tb blocks for each block of one tracer, on
// gridDim.x (tracer_block); tracers_fit is the launchers' check that this
// stays within gridDim.x's 2^31 - 1.
inline dim3 blocks_for(int n, int threads, int Tb = 1) {
  return dim3((n + threads - 1) / threads * Tb);
}

// grid of a tiled node kernel: node tiles x level chunks
inline dim3 tile_grid(int N, int L, int levels, int Tb = 1) {
  return dim3((N + kTileNodes - 1) / kTileNodes * Tb,
              (L + levels - 1) / levels);
}

// the least threads a block of a launcher takes (THREADS in kernels.py)
constexpr int kMinThreads = 64;

// Whether Tb tracers of `per_tracer` blocks each (at the smallest block
// size) fit on gridDim.x, and the rows of Tb tracers' fields of L levels
// (L + 1 interfaces) in an int (K2 and K4 index by row).
inline bool tracers_fit(long long per_tracer, int Tb, int L) {
  return Tb >= 1 && per_tracer * Tb <= 2147483647LL &&
         (long long)(L + 1) * Tb <= 2147483647LL;
}

// dynamic shared memory of H-K34: tile_edges limited fluxes a level
template <typename T>
size_t update_fused_smem(int tile_edges) {
  return (size_t)tile_edges * kUpdateLevels * sizeof(T);
}

// Lets kernel fn take smem bytes of dynamic shared memory a block.  Without
// the attribute a block may take 48 KB less its static shared memory (H-K34's
// staged incidence rows), so it is set for every size; a size above what an
// SM offers is refused here, before a launch.
inline cudaError_t allow_dynamic_smem(const void* fn, size_t smem) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
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

// Calls f(std::true_type) for a launch over Tb > 1 tracers, which takes
// the instances with the tracer axis, else f(std::false_type): a Tb = 1
// launch runs the instances in which the axis folds away.
template <typename F>
void with_tracers(int Tb, F&& f) {
  if (Tb > 1) {
    f(std::true_type{});
  } else {
    f(std::false_type{});
  }
}

// Calls f(Int<MAXD>, Int<THREADS>): the incidence slots in registers (8 or
// kMaxDegree, the least that holds KD) and the block size.  Rows of more
// than 8 slots are instantiated for blocks of at most kMaxWideThreads:
// their node kernels need more registers than a larger block leaves a
// thread, so such a launch is refused.
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
                  int KD, int vlimit, int Tb, int threads, int device,
                  void* stream) {
  if (L < 1 || N < 1 || KD < 1 || KD > kMaxDegree ||
      !tracers_fit((N + kTileNodes - 1) / kTileNodes, Tb, L))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_config(KD, threads, [&](auto d, auto nt) {
    constexpr int D = decltype(d)::value, TH = decltype(nt)::value;
    with_tracers(Tb, [&](auto tr) {
      bounds_kernel<T, D, TH, decltype(tr)::value>
          <<<tile_grid(N, L, kBoundsLevels, Tb), TH, 0, s>>>(
              (const T*)lo, (const T*)ttf, (const int*)nd_other,
              (const int*)nd_lev, (const int*)nd_num, (const int*)nlev_nod,
              (T*)tmax, (T*)tmin, L, N, KD, vlimit, Tb);
    });
  });
}

template <typename T>
int launch_limit(const void* adf_v, const void* tmax, const void* tmin,
                 const void* adf_h, const void* area_inv, const void* nd_idx,
                 const void* nd_lev, const void* nd_sgn, const void* nd_num,
                 const void* nlev_nod, void* plus, void* minus,
                 void* adf_v_lim, void* adf_v_res, int L, int N, int Ed,
                 int KD, double dt, double eps, int Tb, int threads,
                 int device, void* stream) {
  if (L < 1 || N < 1 || Ed < 1 || KD < 1 || KD > kMaxDegree ||
      !tracers_fit((N + kTileNodes - 1) / kTileNodes, Tb, L))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_config(KD, threads, [&](auto d, auto nt) {
    constexpr int D = decltype(d)::value, TH = decltype(nt)::value;
    with_tracers(Tb, [&](auto tr) {
      limit_kernel<T, D, TH, decltype(tr)::value>
          <<<tile_grid(N, L, kLimitLevels, Tb), TH, 0, s>>>(
              (const T*)adf_v, (const T*)tmax, (const T*)tmin,
              (const T*)adf_h, (const T*)area_inv, (const int*)nd_idx,
              (const int*)nd_lev, (const signed char*)nd_sgn,
              (const int*)nd_num, (const int*)nlev_nod, (T*)plus, (T*)minus,
              (T*)adf_v_lim, (T*)adf_v_res, L, N, Ed, KD, (T)dt, (T)eps, Tb);
    });
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
                       int vlimit, double dt, double eps, int Tb,
                       int threads, int device, void* stream) {
  if (L < 1 || N < 1 || Ed < 1 || KD < 1 || KD > kMaxDegree ||
      !tracers_fit((N + kTileNodes - 1) / kTileNodes, Tb, L))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_config(KD, threads, [&](auto d, auto nt) {
    constexpr int D = decltype(d)::value, TH = decltype(nt)::value;
    with_tracers(Tb, [&](auto tr) {
      limit_fused_kernel<T, D, TH, decltype(tr)::value>
          <<<tile_grid(N, L, kLimitFusedLevels, Tb), TH, 0, s>>>(
              (const T*)lo, (const T*)ttf, (const T*)adf_v, (const T*)adf_h,
              (const T*)area_inv, (const int*)nd_idx, (const int*)nd_other,
              (const int*)nd_lev, (const signed char*)nd_sgn,
              (const int*)nd_num, (const int*)nlev_nod, (T*)tmax, (T*)tmin,
              (T*)plus, (T*)minus, (T*)adf_v_lim, (T*)adf_v_res, L, N, Ed,
              KD, vlimit, (T)dt, (T)eps, Tb);
    });
  });
}

template <typename T>
int launch_update_fused(const void* plus, const void* minus,
                        const void* adf_v_lim, const void* adf_h,
                        const void* ttf, const void* hnode,
                        const void* hnode_new, const void* lo,
                        const void* dvin, const void* dhin,
                        const void* area_inv, const void* edges,
                        const void* nlev_edge, const void* ed_ptr,
                        const void* nd_idx, const void* nd_other,
                        const void* nd_lev, const void* nd_sgn,
                        const void* nd_num, const void* nlev_nod, void* o1,
                        void* o2, void* adf_h_lim, void* adf_h_res, int L,
                        int N, int Ed, int KD, int tile_edges, double dt,
                        int iter_yn, int Tb, int threads, int device,
                        void* stream) {
  if (L < 1 || N < 1 || Ed < 1 || KD < 1 || KD > kMaxDegree ||
      tile_edges < 0 ||
      !tracers_fit((N + kTileNodes - 1) / kTileNodes, Tb, L))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = update_fused_smem<T>(tile_edges);
  cudaError_t attr = cudaSuccess;
  const int rc = with_config(KD, threads, [&](auto d, auto nt) {
    constexpr int D = decltype(d)::value, TH = decltype(nt)::value;
    with_tracers(Tb, [&](auto tr) {
      auto* kernel = update_fused_kernel<T, D, TH, decltype(tr)::value>;
      attr = allow_dynamic_smem((const void*)kernel, smem);
      if (attr != cudaSuccess) return;
      kernel<<<tile_grid(N, L, kUpdateLevels, Tb), TH, smem, s>>>(
          (const T*)plus, (const T*)minus, (const T*)adf_v_lim,
          (const T*)adf_h, (const T*)ttf, (const T*)hnode,
          (const T*)hnode_new, (const T*)lo, (const T*)dvin, (const T*)dhin,
          (const T*)area_inv, (const int*)edges, (const int*)nlev_edge,
          (const int*)ed_ptr, (const int*)nd_idx, (const int*)nd_other,
          (const int*)nd_lev, (const signed char*)nd_sgn, (const int*)nd_num,
          (const int*)nlev_nod, (T*)o1, (T*)o2, (T*)adf_h_lim,
          (T*)adf_h_res, L, N, Ed, KD, tile_edges, (T)dt, iter_yn, Tb);
    });
  });
  return attr != cudaSuccess ? attr : rc;
}

template <typename T>
int launch_b3h(const void* plus, const void* minus, const void* adf_h,
               const void* edges, const void* nlev_edge, void* adf_h_lim,
               void* adf_h_res, int L, int N, int Ed, int Tb, int threads,
               int device, void* stream) {
  if (L < 1 || L > 65535 || N < 1 || Ed < 1 ||
      !tracers_fit((Ed + kMinThreads - 1) / kMinThreads, Tb, L))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_threads(threads, [&](auto nt) {
    constexpr int TH = decltype(nt)::value;
    const dim3 grid(blocks_for(Ed, TH, Tb).x, L);
    with_tracers(Tb, [&](auto tr) {
      b3h_kernel<T, TH, decltype(tr)::value><<<grid, TH, 0, s>>>(
          (const T*)plus, (const T*)minus, (const T*)adf_h,
          (const int*)edges, (const int*)nlev_edge, (T*)adf_h_lim,
          (T*)adf_h_res, L, N, Ed, Tb);
    });
  });
}

template <typename T>
int launch_b3h_fixup(const void* plus, const void* minus, const void* adf_h,
                     const void* edges, const void* nlev_edge,
                     const void* ids, void* adf_h_lim, void* adf_h_res,
                     int L, int N, int Ed, int n_ids, int Tb, int threads,
                     int device, void* stream) {
  if (L < 1 || L > 65535 || N < 1 || Ed < 1 || n_ids < 1 ||
      !tracers_fit((n_ids + kMinThreads - 1) / kMinThreads, Tb, L))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_threads(threads, [&](auto nt) {
    constexpr int TH = decltype(nt)::value;
    const dim3 grid(blocks_for(n_ids, TH, Tb).x, L);
    with_tracers(Tb, [&](auto tr) {
      b3h_fixup_kernel<T, TH, decltype(tr)::value><<<grid, TH, 0, s>>>(
          (const T*)plus, (const T*)minus, (const T*)adf_h,
          (const int*)edges, (const int*)nlev_edge, (const int*)ids,
          (T*)adf_h_lim, (T*)adf_h_res, L, N, Ed, n_ids, Tb);
    });
  });
}

// The one block size of K4's FIX form: its instances at 64, 256 and 512
// threads would add more than 10 s to the build for a launch the sharded
// step makes at the default only (kernels.py:FIX_THREADS is a copy).
constexpr int kFixThreads = 128;

// K4, in its plain form or (FIX, with the halo edges' arguments after
// stream) its FIX form, which is instantiated at kFixThreads only
template <typename T, bool FIX = false>
int launch_update(const void* adf_v_lim, const void* adf_h_lim,
                  const void* ttf, const void* hnode, const void* hnode_new,
                  const void* lo, const void* dvin, const void* dhin,
                  const void* area_inv, const void* nd_idx,
                  const void* nd_lev, const void* nd_sgn, const void* nd_num,
                  const void* nlev_nod, void* o1, void* o2, int L, int N,
                  int Ed, int KD, double dt, int iter_yn, int Tb,
                  int threads, int device, void* stream,
                  const void* plus = nullptr, const void* minus = nullptr,
                  const void* adf_h = nullptr,
                  const void* nd_other = nullptr, void* adf_h_res = nullptr,
                  int col_lo = 0, int col_hi = 0) {
  if (L < 1 || N < 1 || Ed < 1 || KD < 1 || KD > kMaxDegree ||
      !tracers_fit((N + kTileNodes - 1) / kTileNodes, Tb, L))
    return cudaErrorInvalidValue;
  if (FIX && (col_lo < 0 || col_lo > col_hi || col_hi > N ||
              threads != kFixThreads))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_config(KD, threads, [&](auto d, auto nt) {
    constexpr int D = decltype(d)::value, TH = decltype(nt)::value;
    if constexpr (!FIX || TH == kFixThreads) {
      with_tracers(Tb, [&](auto tr) {
        constexpr bool TR = decltype(tr)::value;
        update_kernel<T, D, TH, TR, FIX>
            <<<tile_grid(N, L, FIX && !TR ? kFixLevels : kUpdateSplitLevels,
                         Tb),
               TH, 0, s>>>(
                (const T*)adf_v_lim, (const T*)adf_h_lim, (const T*)ttf,
                (const T*)hnode, (const T*)hnode_new, (const T*)lo,
                (const T*)dvin, (const T*)dhin, (const T*)area_inv,
                (const int*)nd_idx, (const int*)nd_lev,
                (const signed char*)nd_sgn, (const int*)nd_num,
                (const int*)nlev_nod, (T*)o1, (T*)o2, L, N, Ed, KD, (T)dt,
                iter_yn, Tb, (const T*)plus, (const T*)minus,
                (const T*)adf_h, (const int*)nd_other, (T*)adf_h_lim,
                (T*)adf_h_res, col_lo, col_hi);
      });
    }
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

// The kernels the occupancy query answers for (kernels.py:OCCUPANCY lists
// them in this order): the default step's K1, K2, K34, then K3, K4, K12,
// then K4's FIX form.
enum OccupancyKernel { kOccBounds, kOccLimit, kOccUpdateFused, kOccB3h,
                       kOccUpdate, kOccLimitFused, kOccUpdateFixup };

// out[0] = resident blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
// and out[1] = grid blocks of the instance a launcher of kernel ``kernel``
// launches at these shapes and this block size, for one tracer.
template <typename T>
int occupancy(int kernel, int L, int N, int Ed, int KD, int tile_edges,
              int* out, int threads, int device) {
  if (L < 1 || N < 1 || Ed < 1 || KD < 1 || KD > kMaxDegree ||
      tile_edges < 0 || out == nullptr)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const void* fn = nullptr;
  dim3 grid;
  size_t smem = 0;
  cudaError_t query = cudaSuccess;
  int rc = with_config(KD, threads, [&](auto d, auto nt) {
    constexpr int D = decltype(d)::value, TH = decltype(nt)::value;
    switch (kernel) {
      case kOccBounds:
        fn = (const void*)bounds_kernel<T, D, TH, false>;
        grid = tile_grid(N, L, kBoundsLevels);
        break;
      case kOccLimit:
        fn = (const void*)limit_kernel<T, D, TH, false>;
        grid = tile_grid(N, L, kLimitLevels);
        break;
      case kOccUpdateFused:
        fn = (const void*)update_fused_kernel<T, D, TH, false>;
        grid = tile_grid(N, L, kUpdateLevels);
        smem = update_fused_smem<T>(tile_edges);
        break;
      case kOccB3h:
        fn = (const void*)b3h_kernel<T, TH, false>;
        grid = dim3((Ed + TH - 1) / TH, L);
        break;
      case kOccUpdate:
        fn = (const void*)update_kernel<T, D, TH, false, false>;
        grid = tile_grid(N, L, kUpdateSplitLevels);
        break;
      case kOccLimitFused:
        fn = (const void*)limit_fused_kernel<T, D, TH, false>;
        grid = tile_grid(N, L, kLimitFusedLevels);
        break;
      case kOccUpdateFixup:
        if constexpr (TH == kFixThreads) {
          fn = (const void*)update_kernel<T, D, TH, false, true>;
          grid = tile_grid(N, L, kFixLevels);
        } else {
          return;  // no instance at this block size
        }
        break;
      default:
        return;
    }
    // as the launch does: H-K34 asks for its dynamic shared memory first
    if (smem > 0) query = allow_dynamic_smem(fn, smem);
    if (query == cudaSuccess)
      query = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], fn, TH,
                                                            smem);
  });
  if (query != cudaSuccess) return query;
  if (rc != cudaSuccess) return rc;
  if (fn == nullptr) return cudaErrorInvalidValue;
  out[1] = (int)(grid.x * grid.y);
  return cudaSuccess;
}

}  // namespace

// Plain C interface.  Every pointer is a device pointer (or null for an
// absent optional output); ``Tb`` (the launchers of K1, K2, K12, K3,
// K3fix, K4, K4's FIX form and K34) is the number of tracers, 1 or more, whose
// per-tracer fields lie tracer-major behind each pointer; ``threads`` is
// the block size (64, 128, 256 or 512, 128 only for K4's FIX form, else
// cudaErrorInvalidValue and no launch); ``stream`` is a cudaStream_t.  Each launcher returns cudaGetLastError() after its launch
// (0 on success) and does not synchronise.
extern "C" {

#define FCT_BOUNDS_ARGS                                                     \
  const void *lo, const void *ttf, const void *nd_other, const void *nd_lev, \
      const void *nd_num, const void *nlev_nod, void *tmax, void *tmin,     \
      int L, int N, int KD, int vlimit, int Tb, int threads, int device,    \
      void *stream
#define FCT_BOUNDS_CALL \
  lo, ttf, nd_other, nd_lev, nd_num, nlev_nod, tmax, tmin, L, N, KD, vlimit, \
      Tb, threads, device, stream

int fct_bounds_f32(FCT_BOUNDS_ARGS) { return launch_bounds<float>(FCT_BOUNDS_CALL); }
int fct_bounds_f64(FCT_BOUNDS_ARGS) { return launch_bounds<double>(FCT_BOUNDS_CALL); }

#define FCT_LIMIT_ARGS                                                       \
  const void *adf_v, const void *tmax, const void *tmin, const void *adf_h,  \
      const void *area_inv, const void *nd_idx, const void *nd_lev,          \
      const void *nd_sgn, const void *nd_num, const void *nlev_nod,          \
      void *plus, void *minus, void *adf_v_lim, void *adf_v_res, int L,      \
      int N, int Ed, int KD, double dt, double eps, int Tb, int threads,    \
      int device, void *stream
#define FCT_LIMIT_CALL                                                      \
  adf_v, tmax, tmin, adf_h, area_inv, nd_idx, nd_lev, nd_sgn, nd_num,       \
      nlev_nod, plus, minus, adf_v_lim, adf_v_res, L, N, Ed, KD, dt, eps,   \
      Tb, threads, device, stream

int fct_limit_f32(FCT_LIMIT_ARGS) { return launch_limit<float>(FCT_LIMIT_CALL); }
int fct_limit_f64(FCT_LIMIT_ARGS) { return launch_limit<double>(FCT_LIMIT_CALL); }

#define FCT_LIMIT_FUSED_ARGS                                                \
  const void *lo, const void *ttf, const void *adf_v, const void *adf_h,    \
      const void *area_inv, const void *nd_idx, const void *nd_other,       \
      const void *nd_lev, const void *nd_sgn, const void *nd_num,           \
      const void *nlev_nod, void *tmax, void *tmin, void *plus,             \
      void *minus, void *adf_v_lim, void *adf_v_res, int L, int N, int Ed,  \
      int KD, int vlimit, double dt, double eps, int Tb, int threads,       \
      int device, void *stream
#define FCT_LIMIT_FUSED_CALL                                                \
  lo, ttf, adf_v, adf_h, area_inv, nd_idx, nd_other, nd_lev, nd_sgn,        \
      nd_num, nlev_nod, tmax, tmin, plus, minus, adf_v_lim, adf_v_res, L,   \
      N, Ed, KD, vlimit, dt, eps, Tb, threads, device, stream

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
      const void *dhin, const void *area_inv, const void *edges,             \
      const void *nlev_edge, const void *ed_ptr, const void *nd_idx,         \
      const void *nd_other, const void *nd_lev, const void *nd_sgn,          \
      const void *nd_num, const void *nlev_nod, void *o1, void *o2,          \
      void *adf_h_lim, void *adf_h_res, int L, int N, int Ed, int KD,        \
      int tile_edges, double dt, int iter_yn, int Tb, int threads,           \
      int device, void *stream
#define FCT_UPDATE_CALL                                                     \
  plus, minus, adf_v_lim, adf_h, ttf, hnode, hnode_new, lo, dvin, dhin,     \
      area_inv, edges, nlev_edge, ed_ptr, nd_idx, nd_other, nd_lev, nd_sgn, \
      nd_num, nlev_nod, o1, o2, adf_h_lim, adf_h_res, L, N, Ed, KD,         \
      tile_edges, dt, iter_yn, Tb, threads, device, stream

int fct_update_fused_f32(FCT_UPDATE_ARGS) {
  return launch_update_fused<float>(FCT_UPDATE_CALL);
}
int fct_update_fused_f64(FCT_UPDATE_ARGS) {
  return launch_update_fused<double>(FCT_UPDATE_CALL);
}

#define FCT_B3H_ARGS                                                        \
  const void *plus, const void *minus, const void *adf_h, const void *edges, \
      const void *nlev_edge, void *adf_h_lim, void *adf_h_res, int L, int N, \
      int Ed, int Tb, int threads, int device, void *stream
#define FCT_B3H_CALL                                                        \
  plus, minus, adf_h, edges, nlev_edge, adf_h_lim, adf_h_res, L, N, Ed,     \
      Tb, threads, device, stream

int fct_b3h_f32(FCT_B3H_ARGS) { return launch_b3h<float>(FCT_B3H_CALL); }
int fct_b3h_f64(FCT_B3H_ARGS) { return launch_b3h<double>(FCT_B3H_CALL); }

#define FCT_B3H_FIXUP_ARGS                                                  \
  const void *plus, const void *minus, const void *adf_h, const void *edges, \
      const void *nlev_edge, const void *ids, void *adf_h_lim,              \
      void *adf_h_res, int L, int N, int Ed, int n_ids, int Tb, int threads, \
      int device, void *stream
#define FCT_B3H_FIXUP_CALL                                                  \
  plus, minus, adf_h, edges, nlev_edge, ids, adf_h_lim, adf_h_res, L, N,    \
      Ed, n_ids, Tb, threads, device, stream

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
      int N, int Ed, int KD, double dt, int iter_yn, int Tb, int threads,   \
      int device, void *stream
#define FCT_UPDATE_SPLIT_CALL                                               \
  adf_v_lim, adf_h_lim, ttf, hnode, hnode_new, lo, dvin, dhin, area_inv,    \
      nd_idx, nd_lev, nd_sgn, nd_num, nlev_nod, o1, o2, L, N, Ed, KD, dt,   \
      iter_yn, Tb, threads, device, stream

int fct_update_f32(FCT_UPDATE_SPLIT_ARGS) {
  return launch_update<float>(FCT_UPDATE_SPLIT_CALL);
}
int fct_update_f64(FCT_UPDATE_SPLIT_ARGS) {
  return launch_update<double>(FCT_UPDATE_SPLIT_CALL);
}

// K4's FIX form: K4's arguments, then the exchanged factors, the raw flux,
// the other endpoints, K3's residual (null unless iter_yn; adf_h_lim is
// K3's limited flux, written in place) and the owned columns
// [own_lo, own_hi)
#define FCT_UPDATE_FIXUP_ARGS                                               \
  const void *adf_v_lim, void *adf_h_lim, const void *ttf,                  \
      const void *hnode, const void *hnode_new, const void *lo,             \
      const void *dvin, const void *dhin, const void *area_inv,             \
      const void *nd_idx, const void *nd_lev, const void *nd_sgn,           \
      const void *nd_num, const void *nlev_nod, void *o1, void *o2,         \
      const void *plus, const void *minus, const void *adf_h,               \
      const void *nd_other, void *adf_h_res, int L, int N, int Ed, int KD,  \
      int own_lo, int own_hi, double dt, int iter_yn, int Tb, int threads,  \
      int device, void *stream
#define FCT_UPDATE_FIXUP_CALL                                               \
  adf_v_lim, adf_h_lim, ttf, hnode, hnode_new, lo, dvin, dhin, area_inv,    \
      nd_idx, nd_lev, nd_sgn, nd_num, nlev_nod, o1, o2, L, N, Ed, KD, dt,   \
      iter_yn, Tb, threads, device, stream, plus, minus, adf_h, nd_other,   \
      adf_h_res, own_lo, own_hi

int fct_update_fixup_f32(FCT_UPDATE_FIXUP_ARGS) {
  return launch_update<float, true>(FCT_UPDATE_FIXUP_CALL);
}
int fct_update_fixup_f64(FCT_UPDATE_FIXUP_ARGS) {
  return launch_update<double, true>(FCT_UPDATE_FIXUP_CALL);
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

// Not a launcher: ``out`` is a host int[2] (see occupancy above).
#define FCT_OCCUPANCY_ARGS                                                  \
  int kernel, int L, int N, int Ed, int KD, int tile_edges, void *out,      \
      int threads, int device
#define FCT_OCCUPANCY_CALL \
  kernel, L, N, Ed, KD, tile_edges, (int *)out, threads, device

int fct_occupancy_f32(FCT_OCCUPANCY_ARGS) {
  return occupancy<float>(FCT_OCCUPANCY_CALL);
}
int fct_occupancy_f64(FCT_OCCUPANCY_ARGS) {
  return occupancy<double>(FCT_OCCUPANCY_CALL);
}

}  // extern "C"
