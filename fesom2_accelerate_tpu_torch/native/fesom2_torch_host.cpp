// Host-embedding C ABI of the PyTorch port: the Fortran/C-callable surface
// of fesom2_accelerate_tpu_torch.
//
// The reference's L1 is an extern "C" library the FESOM2 Fortran host links
// against: setup (set_mpi_rank_, transfer_mesh_, alloc_var_, ...) plus three
// phase entry points driving the GPU pipeline (reference
// include/fesom2-accelerate.h:128-236, src/fesom2-accelerate.cu:258-379).
// This shim embeds CPython and drives fesom2_accelerate_tpu_torch.host_embed,
// which wraps the caller's buffers zero-copy and runs the port's step on the
// card: the plain float64 step (backend 0; on the CPU only where the caller
// sets FESOM2_TORCH_DEVICE=cpu) or the CUDA kernels (backend 1 in float32,
// backend 2 in float64).  Its
// extern "C" block has the names and parameter lists of the JAX package's
// native/fesom2_tpu_host.cpp, so a host links either library unchanged,
// and three more for an MPI rank's partition: f2t_setup_part_ and the
// reference's phases around the host's halo exchange,
// f2t_fct_ale_pre_comm_ and f2t_fct_ale_post_comm_.  Same binding style
// as the reference (trailing-underscore names, pointer-to-scalar args,
// istat out-params, src/fesom2-accelerate.cu:114-127); 0-based
// connectivity.
//
// Thread model: the interpreter is started at most once a process, under
// std::call_once, so concurrent first calls from several host threads are
// safe.  Every entry point then takes the GIL via PyGILState_Ensure, so
// f2t_* calls are safe from any host thread and from hosts that initialized
// Python themselves.  When this shim owns the interpreter it releases the
// GIL after init (PyEval_SaveThread) so the GILState API works uniformly.
// After f2t_finalize_ has finalized an interpreter the shim started, every
// entry point returns istat 1: CPython is not started twice in a process.
//
// Build: python -m fesom2_accelerate_tpu_torch.native.build (g++, links
// libpython).

#include <Python.h>

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <initializer_list>
#include <mutex>

namespace {

PyObject *g_mod = nullptr;  // fesom2_accelerate_tpu_torch.host_embed
bool g_owns_interp = false;
PyThreadState *g_saved = nullptr;  // main thread state parked after init
std::once_flag g_init_once;
std::atomic<bool> g_finalized{false};

// Initialize the interpreter if no host did (once a process, from any
// thread), then park the GIL so every entry can use PyGILState_Ensure.
// Returns false once f2t_finalize_ has finalized it.
bool ensure_interpreter() {
  std::call_once(g_init_once, [] {
    if (!Py_IsInitialized()) {
      Py_InitializeEx(0);
      g_owns_interp = true;
      g_saved = PyEval_SaveThread();
    }
  });
  if (g_finalized.load()) {
    std::fprintf(stderr, "fesom2_torch_host: the interpreter was finalized "
                         "by f2t_finalize_\n");
    return false;
  }
  return true;
}

// RAII GIL hold for one ABI call.
class GilGuard {
 public:
  GilGuard() : st_(PyGILState_Ensure()) {}
  ~GilGuard() { PyGILState_Release(st_); }

 private:
  PyGILState_STATE st_;
};

// Import the port's module (GIL must be held).
bool ensure_module_locked() {
  if (g_mod != nullptr) return true;
  g_mod = PyImport_ImportModule("fesom2_accelerate_tpu_torch.host_embed");
  if (g_mod == nullptr) {
    PyErr_Print();
    return false;
  }
  return true;
}

// Call host_embed.<fn>(args...) -> long; returns -1 on Python-level failure.
// GIL must be held; steals the args reference.
long call_long(const char *fn, PyObject *args) {
  long out = -1;
  PyObject *f = PyObject_GetAttrString(g_mod, fn);
  if (f != nullptr) {
    PyObject *r = PyObject_CallObject(f, args);
    if (r != nullptr) {
      out = PyLong_AsLong(r);
      Py_DECREF(r);
    } else {
      PyErr_Print();
    }
    Py_DECREF(f);
  } else {
    PyErr_Print();
  }
  Py_XDECREF(args);
  return out;
}

// Call host_embed.<fn>(addresses...) -> istat: 0 where it returned 0,
// else 1.  Takes the GIL; the interpreter and module must be up.
int call_addrs(const char *fn, std::initializer_list<const void *> addrs) {
  PyObject *args = PyTuple_New((Py_ssize_t)addrs.size());
  if (args == nullptr) {
    PyErr_Print();
    return 1;
  }
  Py_ssize_t i = 0;
  for (const void *a : addrs) {
    PyObject *v = PyLong_FromLongLong((long long)(uintptr_t)a);
    if (v == nullptr) {
      PyErr_Print();
      Py_DECREF(args);
      return 1;
    }
    PyTuple_SET_ITEM(args, i++, v);  // steals v
  }
  return call_long(fn, args) == 0 ? 0 : 1;
}

}  // namespace

extern "C" {

// Initialize the embedded interpreter + import the port.
void f2t_init_(int *istat) {
  *istat = 1;
  if (!ensure_interpreter()) return;
  GilGuard gil;
  *istat = ensure_module_locked() ? 0 : 1;
}

// One-time mesh transfer + solver build (reference transfer_mesh_ +
// alloc_var_ phase).  elem_nodes: [n_elems, 3] int32 row-major, 0-based;
// nlev_elem: [n_elems] int32; node_xy: [n_nodes, 2] f64.
// backend: 0 = plain torch f64 on the card (correctness; on the CPU where
// FESOM2_TORCH_DEVICE=cpu), 1 = CUDA kernels f32 (flux_eps 1e-7) on the
// card, 2 = CUDA kernels f64 (flux_eps 1e-16, FESOM2's own precision) on
// the card.  istat 1 where there is no card (any backend then), and for
// any other backend number.  dt_milli: timestep in 1e-3 units.
void f2t_setup_(const int *n_elems, const int *nl, const int *elem_nodes,
                const int *nlev_elem, const int *n_nodes,
                const double *node_xy, const int *dt_milli, const int *vlimit,
                const int *iter_yn, const int *backend, int *istat) {
  *istat = 1;
  if (!ensure_interpreter()) return;
  GilGuard gil;
  if (!ensure_module_locked()) return;
  PyObject *args = Py_BuildValue(
      "(iiLLiLiiii)", *n_elems, *nl, (long long)(uintptr_t)elem_nodes,
      (long long)(uintptr_t)nlev_elem, *n_nodes,
      (long long)(uintptr_t)node_xy, *dt_milli, *vlimit, *iter_yn, *backend);
  long r = call_long("setup", args);
  *istat = (r == 0) ? 0 : 1;
}

// Derived sizes the host needs to size its flux buffers.
void f2t_dims_(int *n_nodes, int *n_edges, int *n_layers, int *istat) {
  *istat = 1;
  if (!ensure_interpreter()) return;
  GilGuard gil;
  if (!ensure_module_locked()) return;
  PyObject *f = PyObject_GetAttrString(g_mod, "dims");
  if (f == nullptr) {
    PyErr_Print();
    return;
  }
  PyObject *r = PyObject_CallObject(f, nullptr);
  Py_DECREF(f);
  if (r == nullptr) {
    PyErr_Print();
    return;
  }
  if (PyArg_ParseTuple(r, "iii", n_nodes, n_edges, n_layers)) {
    *istat = 0;
  } else {
    PyErr_Print();
  }
  Py_DECREF(r);
}

// One FCT-ALE step on host-owned f64 buffers (level-major [L, N] node
// fields, [L+1, N] interface fluxes, [L, Ed] edge fluxes).  Limited fluxes
// overwrite fct_adf_v/fct_adf_h; non-iterative mode accumulates del_v/del_h,
// iterative mode updates fct_LO (the stage-c outputs the reference built as
// K10/K11 but never wired into its phase entry points).
//
// On the card the eight buffers move by DMA: the first step that sees a
// buffer page-locks it (cudaHostRegister), and it stays page-locked until
// f2t_finalize_.  A buffer passed to a step must not be freed before
// f2t_finalize_: nothing detects it, and a new buffer at the same address
// and size gives silently wrong results (the step reads and writes the
// old, still locked pages).  So pass the same arrays, allocated once, every
// step, never a temporary (transpose(x), a non-contiguous section): FESOM2
// allocates its fields once for the run, level-fastest (nl-1, node), so a
// FESOM2 host keeps level-major ABI buffers of its own beside them
// (docs/TORCH_USAGE.md section 6).  Every step copies every buffer in and
// its results out; each output buffer is whole when the call returns
// (host_embed.py).
void f2t_fct_ale_step_(const double *ttf, double *fct_LO, double *fct_adf_v,
                       double *fct_adf_h, const double *hnode,
                       const double *hnode_new, double *del_v, double *del_h,
                       int *istat) {
  *istat = 1;
  if (!ensure_interpreter()) return;
  GilGuard gil;
  if (!ensure_module_locked()) return;
  *istat = call_addrs("step", {ttf, fct_LO, fct_adf_v, fct_adf_h, hnode,
                               hnode_new, del_v, del_h});
}

// One MPI rank's partition (host_embed.setup_part): f2t_setup_'s
// parameters, the mesh in FESOM2's local numbering -- the rank's n_owned
// owned nodes (myDim_nod2D) first, then its halo nodes (eDim_nod2D),
// n_nodes in all -- and every element that touches an owned node, with
// local 0-based node ids.  f2t_dims_ then reports the local counts; the
// host sizes its local edge buffers by them, in the library's order: the
// edges derived from the local elements, each running from its lower
// local node id, sorted by it.  An edge flux is signed by that direction,
// so the host negates it, in and out, on an edge whose own runs the other
// way (its global direction, say, where a halo node precedes an owned
// one in the global numbering).  A
// step on a partition with a halo is f2t_fct_ale_pre_comm_, the host's
// exchange_nod of fct_plus/fct_minus, f2t_fct_ale_post_comm_, once per
// tracer; f2t_fct_ale_step_ gives istat 1 there.
void f2t_setup_part_(const int *n_elems, const int *nl,
                     const int *elem_nodes, const int *nlev_elem,
                     const int *n_nodes, const int *n_owned,
                     const double *node_xy, const int *dt_milli,
                     const int *vlimit, const int *iter_yn,
                     const int *backend, int *istat) {
  *istat = 1;
  if (!ensure_interpreter()) return;
  GilGuard gil;
  if (!ensure_module_locked()) return;
  PyObject *args = Py_BuildValue(
      "(iiLLiiLiiii)", *n_elems, *nl, (long long)(uintptr_t)elem_nodes,
      (long long)(uintptr_t)nlev_elem, *n_nodes, *n_owned,
      (long long)(uintptr_t)node_xy, *dt_milli, *vlimit, *iter_yn,
      *backend);
  long r = call_long("setup_part", args);
  *istat = (r == 0) ? 0 : 1;
}

// The step up to the host's exchange (the reference's
// fct_ale_pre_comm_acc_): the eight buffers of f2t_fct_ale_step_ are
// read, and both limiter factors are written, every column, into
// fct_plus and fct_minus ([L, n_nodes] f64, level-major, the host's own
// buffers).  The host's exchange_nod then overwrites their halo columns
// with the owners' values.  Returns once the factors are in the buffers;
// the card meanwhile limits the edges on the pre-exchange factors.  The
// ten buffers are page-locked from their first phase until
// f2t_finalize_, under f2t_fct_ale_step_'s contract: allocated once,
// never freed before f2t_finalize_, never a temporary.
void f2t_fct_ale_pre_comm_(const double *ttf, double *fct_LO,
                           double *fct_adf_v, double *fct_adf_h,
                           const double *hnode, const double *hnode_new,
                           double *del_v, double *del_h, double *fct_plus,
                           double *fct_minus, int *istat) {
  *istat = 1;
  if (!ensure_interpreter()) return;
  GilGuard gil;
  if (!ensure_module_locked()) return;
  *istat = call_addrs("pre_comm", {ttf, fct_LO, fct_adf_v, fct_adf_h, hnode,
                                   hnode_new, del_v, del_h, fct_plus,
                                   fct_minus});
}

// The rest of the step after the host's exchange (the reference's
// fct_ale_post_comm_acc_), on the same ten buffers as the pre_comm before
// it (istat 1 for others, or with no pre_comm before it): only the halo
// columns of fct_plus / fct_minus are read (the owned ones keep
// pre_comm's values, whatever the host left there), and the results are
// written as f2t_fct_ale_step_ writes them, every output buffer whole
// when the call returns.
void f2t_fct_ale_post_comm_(const double *ttf, double *fct_LO,
                            double *fct_adf_v, double *fct_adf_h,
                            const double *hnode, const double *hnode_new,
                            double *del_v, double *del_h,
                            const double *fct_plus, const double *fct_minus,
                            int *istat) {
  *istat = 1;
  if (!ensure_interpreter()) return;
  GilGuard gil;
  if (!ensure_module_locked()) return;
  *istat = call_addrs("post_comm", {ttf, fct_LO, fct_adf_v, fct_adf_h,
                                    hnode, hnode_new, del_v, del_h, fct_plus,
                                    fct_minus});
}

// Ends the session (host_embed.reset): unregisters every buffer a step
// page-locked, so the host may free them after this call.
void f2t_finalize_(int *istat) {
  *istat = 0;
  if (g_finalized.load() || !Py_IsInitialized()) return;
  {
    GilGuard gil;
    if (g_mod != nullptr) {
      call_long("reset", PyTuple_New(0));
      Py_DECREF(g_mod);
      g_mod = nullptr;
    }
  }
  if (g_owns_interp) {
    // re-enter the parked main thread state to finalize
    PyEval_RestoreThread(g_saved);
    g_saved = nullptr;
    g_finalized.store(true);
    if (Py_FinalizeEx() != 0) *istat = 1;
    g_owns_interp = false;
  }
}

}  // extern "C"
