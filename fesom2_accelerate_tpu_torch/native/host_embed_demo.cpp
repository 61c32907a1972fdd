// Demo/integration host for the port's host-embedding ABI
// (fesom2_torch_host.cpp): plays the role of the Fortran host -- owns every
// array in plain C memory, calls the C ABI only.  Mirrors the reference's
// single-kernel integration path (reference src/fesom2-accelerate.cu:42-112:
// validate the library inside a host app before committing to it).
//
// Usage: host_embed_demo <dir>
//   <dir>/meta.txt:  n_elems nl n_nodes dt_milli vlimit iter_yn backend
//                    (backend 0 plain f64, 1 kernels f32, 2 kernels f64)
//   <dir>/*.bin:     raw little-endian arrays (see loads below)
// Writes <dir>/out_{adf_v,adf_h,del_v,del_h,fct_LO}.bin after one step.
// Exit codes: 0 done; 2 bad input files; 3-7 the ABI call that failed
// (init, setup, dims, step, finalize).

#include <cstdio>
#include <cstdlib>
#include <vector>

extern "C" {
void f2t_init_(int *istat);
void f2t_setup_(const int *n_elems, const int *nl, const int *elem_nodes,
                const int *nlev_elem, const int *n_nodes,
                const double *node_xy, const int *dt_milli, const int *vlimit,
                const int *iter_yn, const int *backend, int *istat);
void f2t_dims_(int *n_nodes, int *n_edges, int *n_layers, int *istat);
void f2t_fct_ale_step_(const double *ttf, double *fct_LO, double *fct_adf_v,
                       double *fct_adf_h, const double *hnode,
                       const double *hnode_new, double *del_v, double *del_h,
                       int *istat);
void f2t_finalize_(int *istat);
}

namespace {

template <typename T>
std::vector<T> load(const char *dir, const char *name, size_t count) {
  char path[1024];
  std::snprintf(path, sizeof(path), "%s/%s", dir, name);
  std::vector<T> out(count);
  FILE *f = std::fopen(path, "rb");
  if (f == nullptr || std::fread(out.data(), sizeof(T), count, f) != count) {
    std::fprintf(stderr, "load failed: %s\n", path);
    std::exit(2);
  }
  std::fclose(f);
  return out;
}

void store(const char *dir, const char *name, const double *data,
           size_t count) {
  char path[1024];
  std::snprintf(path, sizeof(path), "%s/%s", dir, name);
  FILE *f = std::fopen(path, "wb");
  if (f == nullptr || std::fwrite(data, sizeof(double), count, f) != count) {
    std::fprintf(stderr, "store failed: %s\n", path);
    std::exit(2);
  }
  std::fclose(f);
}

}  // namespace

int main(int argc, char **argv) {
  if (argc != 2) {
    std::fprintf(stderr, "usage: %s <dir>\n", argv[0]);
    return 2;
  }
  const char *dir = argv[1];
  char path[1024];
  std::snprintf(path, sizeof(path), "%s/meta.txt", dir);
  FILE *mf = std::fopen(path, "r");
  int n_elems, nl, n_nodes, dt_milli, vlimit, iter_yn, backend;
  if (mf == nullptr ||
      std::fscanf(mf, "%d %d %d %d %d %d %d", &n_elems, &nl, &n_nodes,
                  &dt_milli, &vlimit, &iter_yn, &backend) != 7) {
    std::fprintf(stderr, "bad meta.txt\n");
    return 2;
  }
  std::fclose(mf);

  auto elem_nodes = load<int>(dir, "elem_nodes.bin", 3u * n_elems);
  auto nlev_elem = load<int>(dir, "nlev_elem.bin", n_elems);
  auto node_xy = load<double>(dir, "node_xy.bin", 2u * n_nodes);

  int istat = 1;
  f2t_init_(&istat);
  if (istat != 0) return 3;
  f2t_setup_(&n_elems, &nl, elem_nodes.data(), nlev_elem.data(), &n_nodes,
             node_xy.data(), &dt_milli, &vlimit, &iter_yn, &backend, &istat);
  if (istat != 0) return 4;

  int nn = 0, ned = 0, L = 0;
  f2t_dims_(&nn, &ned, &L, &istat);
  if (istat != 0 || nn != n_nodes) return 5;
  std::printf("dims: nodes=%d edges=%d layers=%d\n", nn, ned, L);

  size_t node_sz = (size_t)L * nn;
  auto ttf = load<double>(dir, "ttf.bin", node_sz);
  auto fct_LO = load<double>(dir, "fct_LO.bin", node_sz);
  auto adf_v = load<double>(dir, "adf_v.bin", (size_t)(L + 1) * nn);
  auto adf_h = load<double>(dir, "adf_h.bin", (size_t)L * ned);
  auto hnode = load<double>(dir, "hnode.bin", node_sz);
  auto hnode_new = load<double>(dir, "hnode_new.bin", node_sz);
  auto del_v = load<double>(dir, "del_v.bin", node_sz);
  auto del_h = load<double>(dir, "del_h.bin", node_sz);

  f2t_fct_ale_step_(ttf.data(), fct_LO.data(), adf_v.data(), adf_h.data(),
                    hnode.data(), hnode_new.data(), del_v.data(),
                    del_h.data(), &istat);
  if (istat != 0) return 6;

  store(dir, "out_adf_v.bin", adf_v.data(), (size_t)(L + 1) * nn);
  store(dir, "out_adf_h.bin", adf_h.data(), (size_t)L * ned);
  store(dir, "out_del_v.bin", del_v.data(), node_sz);
  store(dir, "out_del_h.bin", del_h.data(), node_sz);
  store(dir, "out_fct_LO.bin", fct_LO.data(), node_sz);

  f2t_finalize_(&istat);
  return istat == 0 ? 0 : 7;
}
