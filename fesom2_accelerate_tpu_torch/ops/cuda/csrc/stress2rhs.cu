// H-S2R: the sea-ice EVP stress divergence (stress2rhs) for Hopper
// (sm_90a), templated on float/double and on the incidence-slot count (8
// or 16), with extern "C" launchers loaded through ctypes
// (ops/cuda/build.py, ops/cuda/kernels.py).
//
// Replaces both Pallas forms of the same contract:
//   * kernels.py:stress2rhs_pallas, the one-hot form (a windowed one-hot
//     MXU contraction of the per-corner contributions), and
//   * kernels_packed.py:stress2rhs_packed_pallas, the packed form (K
//     home-slot element slabs with lane rolls).
// Both exist because the TPU has no vector gather; Hopper has one.  For
// each node n the kernel sums, over its incident elements e in which n
// sits at corner k (reference src/reference.cpp:440-480):
//   U += -ea * (s11 * g[k] + s12 * g[k+3] + s12 * mf/3)
//   V += -ea * (s12 * g[k] + s22 * g[k+3] - s11 * mf/3)
// with ea = area * (ice_strength > 0), then writes
//   U * inv_areamass + rhs_a and V * inv_areamass + rhs_m where
//   inv_areamass > 0, and 0 elsewhere.
//
// Design:
//   * a gather, never a scatter, and no atomics: each node's sum is taken
//     over its incidence slots in a fixed order, so the sums are identical
//     from run to run (an element-parallel atomicAdd scatter would not be);
//   * kLanesPerNode lanes per node: lane j of a node's group (W aligned
//     lanes of one warp) takes slots j, j + W, ...  Each slot is a chain of
//     dependent loads (the slot code, then ea, then six rows), so a thread
//     that walked a node's slots one by one would wait on each in turn:
//     the kernel is latency-bound, not byte-bound.  Every lane starts its
//     slot codes, then every ea, then the six rows of each ice-covered
//     slot, before it uses any of them: three dependent loads a node, and W
//     times the threads in flight (1,989 blocks of 128 on core2).  The
//     lanes' partial sums are combined
//     with a butterfly of warp shuffles (xor 1, then 2, ...): every lane of
//     the group ends with the same bits, since a + b == b + a in IEEE
//     arithmetic, and the group's first lane writes U, its last V;
//   * the incidence is slot-major, ne_slot[k * N + n] = 3 * e + corner (-1
//     in padding, valid slots first): one int32 load per slot carries both
//     the element and the corner;
//   * the element slab is SoA [11, E] in natural element order (rows s11,
//     s12, s22, ea, mf/3, gradient_sca 0..5).  Neighbouring nodes share
//     elements and element ids follow node ids, so the row reads of a warp
//     fall on few sectors and hit L1/L2;
//   * an ice-free element (ea == 0) is skipped, so its six other rows are
//     not read, and it contributes nothing, as stages.stress2rhs masks it.
// Bound by memory traffic: 7 loads and about 12 flops per incidence.
//
// Built without --use_fast_math; nvcc contracts a*b+c into FMA, and the
// lanes sum the slots in another order than the plain version's slot
// order, so the kernel agrees with it to a relative error and not bit for
// bit.  With every element ice-free the sums are exactly 0, and the
// outputs exactly rhs where inv_areamass > 0.

#include <cuda_runtime.h>
#include <cstddef>
#include <type_traits>

namespace {

// incidence rows wider than this are refused (the wrapper checks first)
constexpr int kMaxSlots = 16;

// lanes per node (kernels.py:S2R_LANES is its copy, held equal by
// tests/test_torch_kernels.py); a power of two that divides 32, 8 and the
// block sizes.  On core2 f32 (an H100) 2 lanes beat 4 and 8 (more threads,
// but more load instructions a byte, the shuffles, and fewer lanes that
// write).
constexpr int kLanesPerNode = 2;

// rows of the element slab
constexpr int kS11 = 0, kS12 = 1, kS22 = 2, kEa = 3, kMf3 = 4, kGrad = 5;

template <typename T, int MAXK, int THREADS>
__global__ void __launch_bounds__(THREADS)
stress2rhs_kernel(const T* __restrict__ slab, const int* __restrict__ ne_slot,
                  const T* __restrict__ inv_areamass,
                  const T* __restrict__ rhs_a, const T* __restrict__ rhs_m,
                  T* __restrict__ u_out, T* __restrict__ v_out, int N, int E,
                  int KE) {
  constexpr int W = kLanesPerNode;
  constexpr int S = MAXK / W;  // slots of one lane
  const int t = blockIdx.x * THREADS + threadIdx.x;
  const int n = t / W;
  const int j = t % W;
  // no early return: every lane of the warp takes part in the shuffles (a
  // group lies wholly before or after N, since W divides 32)
  const bool live = n < N;
  const size_t ld = E;
  int e[S], corner[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int k = j + s * W;
    // padding (-1) and slots past KE take no part
    const int code = live && k < KE ? ne_slot[(size_t)k * N + n] : -1;
    e[s] = code < 0 ? -1 : code / 3;
    corner[s] = code - 3 * e[s];
  }
  T ea[S];
#pragma unroll
  for (int s = 0; s < S; ++s) ea[s] = e[s] < 0 ? T(0) : slab[kEa * ld + e[s]];
  T s11[S] = {}, s12[S] = {}, s22[S] = {}, mf3[S] = {}, g[S] = {}, g3[S] = {};
#pragma unroll
  for (int s = 0; s < S; ++s) {
    if (ea[s] != T(0)) {  // ice-covered: its six rows are read
      s11[s] = slab[kS11 * ld + e[s]];
      s12[s] = slab[kS12 * ld + e[s]];
      s22[s] = slab[kS22 * ld + e[s]];
      mf3[s] = slab[kMf3 * ld + e[s]];
      g[s] = slab[(kGrad + corner[s]) * ld + e[s]];
      g3[s] = slab[(kGrad + 3 + corner[s]) * ld + e[s]];
    }
  }
  T u = T(0), v = T(0);
#pragma unroll
  for (int s = 0; s < S; ++s) {
    if (ea[s] != T(0)) {
      u += -ea[s] * (s11[s] * g[s] + s12[s] * g3[s] + s12[s] * mf3[s]);
      v += -ea[s] * (s12[s] * g[s] + s22[s] * g3[s] - s11[s] * mf3[s]);
    }
  }
#pragma unroll
  for (int m = 1; m < W; m <<= 1) {
    u += __shfl_xor_sync(0xffffffffu, u, m);
    v += __shfl_xor_sync(0xffffffffu, v, m);
  }
  if (!live) return;
  const T iam = inv_areamass[n];
  const bool has_mass = iam > T(0);
  if (j == 0) u_out[n] = has_mass ? u * iam + rhs_a[n] : T(0);
  if (j == W - 1) v_out[n] = has_mass ? v * iam + rhs_m[n] : T(0);
}

template <int V>
using Int = std::integral_constant<int, V>;

template <typename T>
int launch_stress2rhs(const void* slab, const void* ne_slot,
                      const void* inv_areamass, const void* rhs_a,
                      const void* rhs_m, void* u, void* v, int N, int E,
                      int KE, int threads, int device, void* stream) {
  // 3 * E + 2 must fit the int32 slot codes, and the grid's threads
  // (N * kLanesPerNode and a block more) the int32 thread index
  if (N < 1 || (long long)N * kLanesPerNode + 512 > 2147483647LL || E < 1 ||
      E > 715827882 || KE < 1 || KE > kMaxSlots)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto k, auto nt) {
    constexpr int K = decltype(k)::value, TH = decltype(nt)::value;
    const int blocks = (int)(((long long)N * kLanesPerNode + TH - 1) / TH);
    stress2rhs_kernel<T, K, TH><<<dim3(blocks), TH, 0, s>>>(
        (const T*)slab, (const int*)ne_slot, (const T*)inv_areamass,
        (const T*)rhs_a, (const T*)rhs_m, (T*)u, (T*)v, N, E, KE);
  };
  // one instance per block size, each with __launch_bounds__ of its size,
  // as in fct_ale.cu; any other size is refused before a launch
  auto sized = [&](auto nt) {
    if (KE <= 8) launch(Int<8>{}, nt);
    else launch(Int<kMaxSlots>{}, nt);
  };
  switch (threads) {
    case 64: sized(Int<64>{}); break;
    case 128: sized(Int<128>{}); break;
    case 256: sized(Int<256>{}); break;
    case 512: sized(Int<512>{}); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// Plain C interface.  Every pointer is a device pointer; ``threads`` is the
// block size (64, 128, 256 or 512); ``stream`` is a cudaStream_t.  Each
// launcher returns cudaGetLastError() after its launch (0 on success) and
// does not synchronise.
extern "C" {

#define S2R_ARGS                                                             \
  const void *slab, const void *ne_slot, const void *inv_areamass,           \
      const void *rhs_a, const void *rhs_m, void *u, void *v, int N, int E,  \
      int KE, int threads, int device, void *stream
#define S2R_CALL                                                              \
  slab, ne_slot, inv_areamass, rhs_a, rhs_m, u, v, N, E, KE, threads, device, \
      stream

int stress2rhs_f32(S2R_ARGS) { return launch_stress2rhs<float>(S2R_CALL); }
int stress2rhs_f64(S2R_ARGS) { return launch_stress2rhs<double>(S2R_CALL); }

}  // extern "C"
