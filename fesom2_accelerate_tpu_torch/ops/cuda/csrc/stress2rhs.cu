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
//   * a gather, never a scatter: one thread per node loops over its
//     incidence slots in slot order, so there are no atomics and the f32
//     sums are identical from run to run (an element-parallel atomicAdd
//     scatter would not be);
//   * the incidence is slot-major, ne_slot[k * N + n] = 3 * e + corner (-1
//     in padding, valid slots first): one coalesced int32 load per slot
//     carries both the element and the corner;
//   * the element slab is SoA [11, E] in natural element order (rows s11,
//     s12, s22, ea, mf/3, gradient_sca 0..5).  Neighbouring nodes share
//     elements and element ids follow node ids, so the row reads of a warp
//     fall on few sectors and hit L1/L2;
//   * an ice-free element (ea == 0) is skipped, so its six other rows are
//     not read, and it contributes nothing, as stages.stress2rhs masks it.
// Bound by memory traffic: 7 loads and about 12 flops per incidence.
//
// Built without --use_fast_math; nvcc contracts a*b+c into FMA, so the
// kernel agrees with its plain version (same slot order, same masks) to a
// relative error and not bit for bit.  With every element ice-free the
// sums are exactly 0, and the outputs exactly rhs where inv_areamass > 0.

#include <cuda_runtime.h>
#include <cstddef>
#include <type_traits>

namespace {

// incidence rows wider than this are refused (the wrapper checks first)
constexpr int kMaxSlots = 16;

// rows of the element slab
constexpr int kS11 = 0, kS12 = 1, kS22 = 2, kEa = 3, kMf3 = 4, kGrad = 5;

template <typename T, int MAXK, int THREADS>
__global__ void __launch_bounds__(THREADS)
stress2rhs_kernel(const T* __restrict__ slab, const int* __restrict__ ne_slot,
                  const T* __restrict__ inv_areamass,
                  const T* __restrict__ rhs_a, const T* __restrict__ rhs_m,
                  T* __restrict__ u_out, T* __restrict__ v_out, int N, int E,
                  int KE) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const size_t ld = E;
  T u = T(0), v = T(0);
#pragma unroll
  for (int k = 0; k < MAXK; ++k) {
    if (k >= KE) break;
    const int code = ne_slot[(size_t)k * N + n];
    if (code < 0) break;  // padding: the valid slots come first
    const int e = code / 3;
    const int corner = code - 3 * e;
    const T ea = slab[kEa * ld + e];
    if (ea == T(0)) continue;  // ice-free element
    const T s11 = slab[kS11 * ld + e];
    const T s12 = slab[kS12 * ld + e];
    const T s22 = slab[kS22 * ld + e];
    const T mf3 = slab[kMf3 * ld + e];
    const T g = slab[(kGrad + corner) * ld + e];
    const T g3 = slab[(kGrad + 3 + corner) * ld + e];
    u += -ea * (s11 * g + s12 * g3 + s12 * mf3);
    v += -ea * (s12 * g + s22 * g3 - s11 * mf3);
  }
  const T iam = inv_areamass[n];
  const bool has_mass = iam > T(0);
  u_out[n] = has_mass ? u * iam + rhs_a[n] : T(0);
  v_out[n] = has_mass ? v * iam + rhs_m[n] : T(0);
}

template <int V>
using Int = std::integral_constant<int, V>;

template <typename T>
int launch_stress2rhs(const void* slab, const void* ne_slot,
                      const void* inv_areamass, const void* rhs_a,
                      const void* rhs_m, void* u, void* v, int N, int E,
                      int KE, int threads, int device, void* stream) {
  // 3 * E + 2 must fit the int32 slot codes
  if (N < 1 || E < 1 || E > 715827882 || KE < 1 || KE > kMaxSlots)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto k, auto nt) {
    constexpr int K = decltype(k)::value, TH = decltype(nt)::value;
    stress2rhs_kernel<T, K, TH><<<dim3((N + TH - 1) / TH), TH, 0, s>>>(
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
