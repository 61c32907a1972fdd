// fesom2_torch_core — the PyTorch port's copy of native/fesom2_tpu_core.cpp.
//
// The same extern "C" names, parameter lists and code as the JAX package's
// native core, built by fesom2_accelerate_tpu_torch/native/build.py (g++,
// the same flags as native/Makefile) and bound with ctypes by
// fesom2_accelerate_tpu_torch/mesh/native.py.  The port keeps its own copy
// so that its build never reaches into native/.
//
//  1. MESH CORE: derivation of edges / edge-triangle adjacency / transposed
//     incidences from the element list (the graph-builder; the same
//     contract as mesh/topology.py's _build_edges and _ragged_to_padded).
//     At CORE2 scale (~127k nodes / ~254k elements) this is the host-side
//     setup cost.
//
//  2. CPU GOLDEN REFERENCE: the staged FCT-ALE chain in the framework's
//     level-major [L, X] layout, f64, 0-based — semantics per reference
//     src/reference.cpp:306-438 and the Fortran spec at
//     docs/refactoring.md:12-316 — and the EVP stress2rhs scatter
//     (src/reference.cpp:440-480).  A second implementation of the pinned
//     semantics, independent of the numpy oracle and of the CUDA kernels
//     (the reference's L5 layer).
//
// All buffers caller-allocated; two-phase "count then fill" calls where
// sizes are data-dependent.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// 1. Mesh core
// ---------------------------------------------------------------------------

// Count unique undirected edges of a triangle mesh.  Returns -1 on
// non-manifold input (an edge shared by >2 triangles).
int64_t f2t_count_edges(const int32_t* elem_nodes, int64_t n_elems,
                        int64_t n_nodes) {
  std::vector<int64_t> half(3 * n_elems);
  for (int64_t e = 0; e < n_elems; ++e) {
    for (int k = 0; k < 3; ++k) {
      int64_t a = elem_nodes[3 * e + k];
      int64_t b = elem_nodes[3 * e + (k + 1) % 3];
      int64_t lo = std::min(a, b), hi = std::max(a, b);
      half[3 * e + k] = lo * n_nodes + hi;
    }
  }
  std::sort(half.begin(), half.end());
  int64_t count = 0;
  int64_t run = 0;
  for (size_t i = 0; i < half.size(); ++i) {
    if (i == 0 || half[i] != half[i - 1]) {
      count++;
      run = 1;
    } else if (++run > 2) {
      return -1;
    }
  }
  return count;
}

// Build edges [Ed,2] and edge_tri [Ed,2] (right = -1 on boundary).
// Canonical orientation n0 < n1 with left/right triangles swapped on flip
// (single boundary triangle kept in slot 0), matching mesh/topology.py
// exactly (stable order: sorted by (min,max) key, ties by triangle index).
// Returns 0, or -1 on non-manifold input.
int32_t f2t_build_edges(const int32_t* elem_nodes, int64_t n_elems,
                        int64_t n_nodes, int32_t* edges /*[Ed,2]*/,
                        int32_t* edge_tri /*[Ed,2]*/) {
  struct Half {
    int64_t key;
    int32_t src, dst, tri;
  };
  std::vector<Half> half(3 * n_elems);
  for (int64_t e = 0; e < n_elems; ++e) {
    for (int k = 0; k < 3; ++k) {
      int32_t a = elem_nodes[3 * e + k];
      int32_t b = elem_nodes[3 * e + (k + 1) % 3];
      int64_t lo = std::min(a, b), hi = std::max(a, b);
      half[3 * e + k] = {lo * n_nodes + hi, a, b, (int32_t)e};
    }
  }
  std::stable_sort(half.begin(), half.end(),
                   [](const Half& x, const Half& y) { return x.key < y.key; });
  int64_t ed = -1;
  int64_t run = 0;
  for (size_t i = 0; i < half.size(); ++i) {
    if (i == 0 || half[i].key != half[i - 1].key) {
      ++ed;
      run = 1;
      edges[2 * ed] = half[i].src;
      edges[2 * ed + 1] = half[i].dst;
      edge_tri[2 * ed] = half[i].tri;
      edge_tri[2 * ed + 1] = -1;
    } else {
      if (++run > 2) return -1;
      edge_tri[2 * ed + 1] = half[i].tri;
    }
  }
  for (int64_t e2 = 0; e2 <= ed; ++e2) {
    if (edges[2 * e2] > edges[2 * e2 + 1]) {
      std::swap(edges[2 * e2], edges[2 * e2 + 1]);
      std::swap(edge_tri[2 * e2], edge_tri[2 * e2 + 1]);
    }
    if (edge_tri[2 * e2] < 0) {
      std::swap(edge_tri[2 * e2], edge_tri[2 * e2 + 1]);
    }
  }
  return 0;
}

// Transposed incidence: for (row -> list of (col, payload)) pairs given as
// flat (rows[i], cols[i], payload[i]), emit padded [n_rows, K] arrays.
// Returns max degree K (caller first calls with padded==nullptr to size).
int32_t f2t_ragged_to_padded(const int32_t* rows, const int32_t* cols,
                             const int32_t* payload, int64_t n_pairs,
                             int64_t n_rows, int32_t K,
                             int32_t* padded /*[n_rows,K] or null*/,
                             int32_t* padded_payload /*[n_rows,K] or null*/,
                             int32_t* counts /*[n_rows]*/) {
  std::vector<int32_t> cnt(n_rows, 0);
  for (int64_t i = 0; i < n_pairs; ++i) cnt[rows[i]]++;
  int32_t maxk = 0;
  for (int64_t r = 0; r < n_rows; ++r) maxk = std::max(maxk, cnt[r]);
  if (counts) {
    std::memcpy(counts, cnt.data(), n_rows * sizeof(int32_t));
  }
  if (!padded) return maxk;
  std::fill(padded, padded + n_rows * K, -1);
  if (padded_payload) std::fill(padded_payload, padded_payload + n_rows * K, -1);
  std::vector<int32_t> slot(n_rows, 0);
  for (int64_t i = 0; i < n_pairs; ++i) {
    int64_t r = rows[i];
    int32_t s = slot[r]++;
    padded[r * K + s] = cols[i];
    if (padded_payload) padded_payload[r * K + s] = payload ? payload[i] : 0;
  }
  return maxk;
}

// Per-node vertical extent = max over incident elements (FESOM invariant),
// and per-edge active layers = max over <=2 adjacent triangles.
void f2t_levels(const int32_t* elem_nodes, const int32_t* nlev_elem,
                int64_t n_elems, int64_t n_nodes, const int32_t* edge_tri,
                int64_t n_edges, int32_t* nlev_nod /*[N]*/,
                int32_t* nlev_edge /*[Ed]*/) {
  std::fill(nlev_nod, nlev_nod + n_nodes, 0);
  for (int64_t e = 0; e < n_elems; ++e) {
    for (int k = 0; k < 3; ++k) {
      int32_t n = elem_nodes[3 * e + k];
      nlev_nod[n] = std::max(nlev_nod[n], nlev_elem[e]);
    }
  }
  for (int64_t ed = 0; ed < n_edges; ++ed) {
    int32_t l = edge_tri[2 * ed];
    int32_t r = edge_tri[2 * ed + 1];
    int32_t nl1 = nlev_elem[l] - 1;
    int32_t nl2 = (r >= 0) ? nlev_elem[r] - 1 : 0;
    nlev_edge[ed] = std::max(nl1, nl2);
  }
}

// ---------------------------------------------------------------------------
// 2. CPU golden reference (level-major [L, X], f64, 0-based)
//    Stage semantics per reference src/reference.cpp:306-438 +
//    docs/refactoring.md:12-316; layout is this framework's, not the
//    reference's flat strided one.
// ---------------------------------------------------------------------------

// a1 (reference src/reference.cpp:306-319)
void f2t_a1(int64_t L, int64_t N, const int32_t* nlev_nod,
            const double* fct_LO, const double* ttf, double* tmax,
            double* tmin) {
  for (int64_t n = 0; n < N; ++n) {
    for (int64_t z = 0; z < L; ++z) {
      int64_t i = z * N + n;
      if (z < nlev_nod[n] - 1) {
        tmax[i] = std::max(fct_LO[i], ttf[i]);
        tmin[i] = std::min(fct_LO[i], ttf[i]);
      } else {
        tmax[i] = 0.0;
        tmin[i] = 0.0;
      }
    }
  }
}

// a2 (reference src/reference.cpp:321-351; full-depth bignumber padding)
void f2t_a2(int64_t L, int64_t N, int64_t E, const int32_t* elem_nodes,
            const int32_t* nlev_elem, const double* tmax, const double* tmin,
            double bignumber, double* UV_max, double* UV_min) {
  for (int64_t e = 0; e < E; ++e) {
    int32_t n0 = elem_nodes[3 * e], n1 = elem_nodes[3 * e + 1],
            n2 = elem_nodes[3 * e + 2];
    for (int64_t z = 0; z < L; ++z) {
      int64_t i = z * E + e;
      if (z < nlev_elem[e] - 1) {
        UV_max[i] = std::max(std::max(tmax[z * N + n0], tmax[z * N + n1]),
                             tmax[z * N + n2]);
        UV_min[i] = std::min(std::min(tmin[z * N + n0], tmin[z * N + n1]),
                             tmin[z * N + n2]);
      } else {
        UV_max[i] = -bignumber;
        UV_min[i] = bignumber;
      }
    }
  }
}

// a3, vlimit=1 (reference src/reference.cpp:353-392)
void f2t_a3_vlimit1(int64_t L, int64_t N, int64_t E, const int32_t* nlev_nod,
                    const int32_t* node_elems, const int32_t* node_elems_num,
                    int32_t K, const double* UV_max, const double* UV_min,
                    const double* fct_LO, double* out_max, double* out_min) {
  std::vector<double> tvx(L), tvn(L);
  for (int64_t n = 0; n < N; ++n) {
    int32_t nlev = nlev_nod[n];
    for (int64_t z = 0; z + 1 < nlev; ++z) {
      double mx = -1e300, mn = 1e300;
      for (int32_t k = 0; k < node_elems_num[n]; ++k) {
        int32_t e = node_elems[n * K + k];
        mx = std::max(mx, UV_max[z * E + e]);
        mn = std::min(mn, UV_min[z * E + e]);
      }
      tvx[z] = mx;
      tvn[z] = mn;
    }
    for (int64_t z = 0; z < L; ++z) {
      int64_t i = z * N + n;
      if (z >= nlev - 1) {
        out_max[i] = 0.0;
        out_min[i] = 0.0;
      } else if (z == 0 || z >= nlev - 2) {
        out_max[i] = tvx[z] - fct_LO[i];
        out_min[i] = tvn[z] - fct_LO[i];
      } else {
        out_max[i] = std::max(std::max(tvx[z - 1], tvx[z]), tvx[z + 1]) -
                     fct_LO[i];
        out_min[i] = std::min(std::min(tvn[z - 1], tvn[z]), tvn[z + 1]) -
                     fct_LO[i];
      }
    }
  }
}

// b1 vertical + horizontal (reference src/reference.cpp:393-425)
void f2t_b1(int64_t L, int64_t N, int64_t Ed, const int32_t* nlev_nod,
            const int32_t* edges, const int32_t* nlev_edge,
            const double* fct_adf_v /*[L+1,N]*/,
            const double* fct_adf_h /*[L,Ed]*/, double* fct_plus,
            double* fct_minus) {
  for (int64_t n = 0; n < N; ++n) {
    for (int64_t z = 0; z < L; ++z) {
      int64_t i = z * N + n;
      if (z < nlev_nod[n] - 1) {
        double up = fct_adf_v[z * N + n];
        double dn = fct_adf_v[(z + 1) * N + n];
        fct_plus[i] = std::max(0.0, up) + std::max(0.0, -dn);
        fct_minus[i] = std::min(0.0, up) + std::min(0.0, -dn);
      } else {
        fct_plus[i] = 0.0;
        fct_minus[i] = 0.0;
      }
    }
  }
  for (int64_t ed = 0; ed < Ed; ++ed) {
    int32_t n1 = edges[2 * ed], n2 = edges[2 * ed + 1];
    for (int32_t z = 0; z < nlev_edge[ed]; ++z) {
      double f = fct_adf_h[z * Ed + ed];
      fct_plus[z * N + n1] += std::max(0.0, f);
      fct_minus[z * N + n1] += std::min(0.0, f);
      fct_plus[z * N + n2] += std::max(0.0, -f);
      fct_minus[z * N + n2] += std::min(0.0, -f);
    }
  }
}

// b2 (reference src/reference.cpp:426-437, area_inv form)
void f2t_b2(int64_t L, int64_t N, const int32_t* nlev_nod,
            const double* area_inv /*[L,N] layer rows*/, const double* tmax,
            const double* tmin, double dt, double flux_eps, double* fct_plus,
            double* fct_minus) {
  for (int64_t n = 0; n < N; ++n) {
    for (int64_t z = 0; z < L; ++z) {
      int64_t i = z * N + n;
      if (z < nlev_nod[n] - 1) {
        double flux = fct_plus[i] * dt * area_inv[i] + flux_eps;
        fct_plus[i] = std::min(1.0, tmax[i] / flux);
        flux = fct_minus[i] * dt * area_inv[i] - flux_eps;
        fct_minus[i] = std::min(1.0, tmin[i] / flux);
      } else {
        fct_plus[i] = 0.0;
        fct_minus[i] = 0.0;
      }
    }
  }
}

// b3 vertical (docs/refactoring.md:204-233); fct_adf_v limited in place,
// residual (1-ae)*f to adf_v2 for z>=1 when iter_yn
void f2t_b3_vertical(int64_t L, int64_t N, const int32_t* nlev_nod,
                     const double* fct_plus, const double* fct_minus,
                     double* fct_adf_v /*[L+1,N]*/, int32_t iter_yn,
                     double* fct_adf_v2 /*[L+1,N] or null*/) {
  for (int64_t n = 0; n < N; ++n) {
    int32_t nlev = nlev_nod[n];
    {
      double ae = 1.0;
      double f = fct_adf_v[n];
      ae = std::min(ae, (f >= 0.0) ? fct_plus[n] : fct_minus[n]);
      fct_adf_v[n] = ae * f;
    }
    for (int32_t z = 1; z < nlev - 1; ++z) {
      int64_t i = z * N + n;
      double ae = 1.0;
      double f = fct_adf_v[i];
      if (f >= 0.0) {
        ae = std::min(ae, fct_minus[(z - 1) * N + n]);
        ae = std::min(ae, fct_plus[i]);
      } else {
        ae = std::min(ae, fct_plus[(z - 1) * N + n]);
        ae = std::min(ae, fct_minus[i]);
      }
      if (iter_yn && fct_adf_v2) fct_adf_v2[i] = (1.0 - ae) * f;
      fct_adf_v[i] = ae * f;
    }
  }
}

// b3 horizontal (docs/refactoring.md:238-263)
void f2t_b3_horizontal(int64_t L, int64_t N, int64_t Ed, const int32_t* edges,
                       const int32_t* nlev_edge, const double* fct_plus,
                       const double* fct_minus, double* fct_adf_h /*[L,Ed]*/,
                       int32_t iter_yn, double* fct_adf_h2 /*or null*/) {
  for (int64_t ed = 0; ed < Ed; ++ed) {
    int32_t n1 = edges[2 * ed], n2 = edges[2 * ed + 1];
    for (int32_t z = 0; z < nlev_edge[ed]; ++z) {
      int64_t i = z * Ed + ed;
      double ae = 1.0;
      double f = fct_adf_h[i];
      if (f >= 0.0) {
        ae = std::min(ae, fct_plus[z * N + n1]);
        ae = std::min(ae, fct_minus[z * N + n2]);
      } else {
        ae = std::min(ae, fct_minus[z * N + n1]);
        ae = std::min(ae, fct_plus[z * N + n2]);
      }
      if (iter_yn && fct_adf_h2) fct_adf_h2[i] = (1.0 - ae) * f;
      fct_adf_h[i] = ae * f;
    }
  }
}

// c, non-iterative (docs/refactoring.md:295-314)
void f2t_c_update_solution(int64_t L, int64_t N, int64_t Ed,
                           const int32_t* nlev_nod, const int32_t* edges,
                           const int32_t* nlev_edge, const double* ttf,
                           const double* hnode, const double* hnode_new,
                           const double* fct_LO, const double* fct_adf_v,
                           const double* fct_adf_h, const double* area_inv,
                           double dt, double* del_v, double* del_h) {
  for (int64_t n = 0; n < N; ++n) {
    for (int32_t z = 0; z + 1 < nlev_nod[n]; ++z) {
      int64_t i = z * N + n;
      del_v[i] += -ttf[i] * hnode[i] + fct_LO[i] * hnode_new[i] +
                  (fct_adf_v[z * N + n] - fct_adf_v[(z + 1) * N + n]) * dt *
                      area_inv[i];
    }
  }
  for (int64_t ed = 0; ed < Ed; ++ed) {
    int32_t n1 = edges[2 * ed], n2 = edges[2 * ed + 1];
    for (int32_t z = 0; z < nlev_edge[ed]; ++z) {
      double f = fct_adf_h[z * Ed + ed];
      del_h[z * N + n1] += f * dt * area_inv[z * N + n1];
      del_h[z * N + n2] -= f * dt * area_inv[z * N + n2];
    }
  }
}

// c, iterative (docs/refactoring.md:269-286)
void f2t_c_update_LO(int64_t L, int64_t N, int64_t Ed,
                     const int32_t* nlev_nod, const int32_t* edges,
                     const int32_t* nlev_edge, const double* fct_adf_v,
                     const double* fct_adf_h, const double* area_inv,
                     const double* hnode_new, double dt, double* fct_LO) {
  for (int64_t n = 0; n < N; ++n) {
    for (int32_t z = 0; z + 1 < nlev_nod[n]; ++z) {
      int64_t i = z * N + n;
      fct_LO[i] += (fct_adf_v[z * N + n] - fct_adf_v[(z + 1) * N + n]) * dt *
                   area_inv[i] / hnode_new[i];
    }
  }
  for (int64_t ed = 0; ed < Ed; ++ed) {
    int32_t n1 = edges[2 * ed], n2 = edges[2 * ed + 1];
    for (int32_t z = 0; z < nlev_edge[ed]; ++z) {
      double f = fct_adf_h[z * Ed + ed];
      fct_LO[z * N + n1] += f * dt * area_inv[z * N + n1] / hnode_new[z * N + n1];
      fct_LO[z * N + n2] -= f * dt * area_inv[z * N + n2] / hnode_new[z * N + n2];
    }
  }
}

// stress2rhs (reference src/reference.cpp:440-480); gradient_sca is [6, E]
void f2t_stress2rhs(int64_t N, int64_t E, const int32_t* elem_nodes,
                    const double* elem_area, const double* ice_strength,
                    const double* sigma11, const double* sigma12,
                    const double* sigma22, const double* gradient_sca,
                    const double* metric_factor, const double* inv_areamass,
                    const double* rhs_a, const double* rhs_m, double* U,
                    double* V) {
  const double third = 1.0 / 3.0;
  std::fill(U, U + N, 0.0);
  std::fill(V, V + N, 0.0);
  for (int64_t e = 0; e < E; ++e) {
    if (ice_strength[e] > 0.0) {
      for (int k = 0; k < 3; ++k) {
        int32_t n = elem_nodes[3 * e + k];
        double gk = gradient_sca[k * E + e];
        double gk3 = gradient_sca[(k + 3) * E + e];
        U[n] -= elem_area[e] *
                (sigma11[e] * gk + sigma12[e] * gk3 + sigma12[e] * third * metric_factor[e]);
        V[n] -= elem_area[e] *
                (sigma12[e] * gk + sigma22[e] * gk3 - sigma11[e] * third * metric_factor[e]);
      }
    }
  }
  for (int64_t n = 0; n < N; ++n) {
    if (inv_areamass[n] > 0.0) {
      U[n] = U[n] * inv_areamass[n] + rhs_a[n];
      V[n] = V[n] * inv_areamass[n] + rhs_m[n];
    } else {
      U[n] = 0.0;
      V[n] = 0.0;
    }
  }
}

}  // extern "C"
