// Python binding of the kernels' C entry points (bilateral.cu, fusion.cu,
// march.cu, icp.cu, gather_probes.cu), built with them by torch.utils.cpp_extension.load. The only
// source that includes PyTorch's headers. The wrappers in ops/kernels.py
// check device, type, shape and contiguity; each function here launches on
// the stream it is given and returns the launch's cudaError_t.

#include <torch/extension.h>

extern "C" int xs_bilateral_filter(const void* src, void* dst, int H, int W, void* stream);
extern "C" int xs_fuse_volume(void* value, void* grad, void* weight, const void* depth, const void* pose,
                              int X, int Y, int Z, int H, int W,
                              float vs, float fx, float fy, float cx, float cy,
                              float inv_fx, float inv_fy, float trunc, float inv_trunc, float max_w,
                              void* stream);
extern "C" int xs_march_fixed(const void* value, const void* start, const void* dirs, void* t_found,
                              void* t_dead, int X, int Y, int Z, int H, int W, int n_steps, float vs,
                              float step, void* stream);
extern "C" int xs_icp_system(const void* vcurr, const void* ncurr, const void* rows, const void* assoc,
                             const void* pose, void* partials, void* ticket, int blocks, void* out,
                             void* inliers, void* pose_out, void* x_out, void* flags, float damping, int first,
                             int Hc, int Wc, int Hp, int Wp, float fx, float fy, float cx, float cy,
                             float dist_thres, float angle_thres, void* stream);
extern "C" int xs_icp_associate(const void* vcurr, const void* pose, void* assoc, int Hc, int Wc, int Hp,
                                int Wp, float fx, float fy, float cx, float cy, void* stream);
extern "C" int xs_probe_a(const void* table, const void* idx, void* out, int n, void* stream);
extern "C" int xs_probe_b(const void* table, const void* idx, void* out, int n, void* stream);
extern "C" int xs_probe_c(const void* table, void* out, void* stream);
extern "C" int xs_probe_d(const void* table, void* out, int n, void* stream);
extern "C" int xs_probe_e(const void* table, const void* idx0, void* out, int n, int n_rows, int n_steps,
                          void* stream);

namespace {

void* as_stream(int64_t stream) { return reinterpret_cast<void*>(stream); }

int bilateral_filter(const torch::Tensor& depth, torch::Tensor out, int64_t stream) {
  return xs_bilateral_filter(depth.data_ptr(), out.data_ptr(), depth.size(0), depth.size(1), as_stream(stream));
}

int fuse_volume(torch::Tensor value, torch::Tensor grad, torch::Tensor weight, const torch::Tensor& depth,
                const torch::Tensor& pose, float vs, float fx, float fy, float cx, float cy, float inv_fx,
                float inv_fy, float trunc, float inv_trunc, float max_w, int64_t stream) {
  return xs_fuse_volume(value.data_ptr(), grad.data_ptr(), weight.data_ptr(), depth.data_ptr(), pose.data_ptr(),
                        value.size(0), value.size(1), value.size(2), depth.size(0), depth.size(1),
                        vs, fx, fy, cx, cy, inv_fx, inv_fy, trunc, inv_trunc, max_w, as_stream(stream));
}

int march_fixed(const torch::Tensor& value, const torch::Tensor& start, const torch::Tensor& dirs,
                torch::Tensor t_found, torch::Tensor t_dead, int64_t n_steps, float vs, float step,
                int64_t stream) {
  return xs_march_fixed(value.data_ptr(), start.data_ptr(), dirs.data_ptr(), t_found.data_ptr(),
                        t_dead.data_ptr(), value.size(0), value.size(1), value.size(2), t_found.size(0),
                        t_found.size(1), n_steps, vs, step, as_stream(stream));
}

void* data_or_null(const std::optional<torch::Tensor>& t) { return t.has_value() ? t->data_ptr() : nullptr; }

// assoc: the cached int32 index map, or None to project in the kernel.
// pose_out, x_out, flags: the tail's outputs, or None to stop after A and b.
int icp_system(const torch::Tensor& vcurr, const torch::Tensor& ncurr, const torch::Tensor& rows,
               const std::optional<torch::Tensor>& assoc, const torch::Tensor& pose, torch::Tensor partials,
               torch::Tensor ticket, int64_t blocks, torch::Tensor out, torch::Tensor inliers,
               const std::optional<torch::Tensor>& pose_out, const std::optional<torch::Tensor>& x_out,
               const std::optional<torch::Tensor>& flags, float damping, bool first, int64_t Hp, int64_t Wp,
               float fx, float fy, float cx, float cy, float dist_thres, float angle_thres, int64_t stream) {
  return xs_icp_system(vcurr.data_ptr(), ncurr.data_ptr(), rows.data_ptr(), data_or_null(assoc), pose.data_ptr(),
                       partials.data_ptr(), ticket.data_ptr(), blocks, out.data_ptr(), inliers.data_ptr(),
                       data_or_null(pose_out), data_or_null(x_out), data_or_null(flags), damping, first ? 1 : 0,
                       vcurr.size(1), vcurr.size(2), Hp, Wp, fx, fy, cx, cy, dist_thres, angle_thres,
                       as_stream(stream));
}

int icp_associate(const torch::Tensor& vcurr, const torch::Tensor& pose, torch::Tensor assoc, int64_t Hp,
                  int64_t Wp, float fx, float fy, float cx, float cy, int64_t stream) {
  return xs_icp_associate(vcurr.data_ptr(), pose.data_ptr(), assoc.data_ptr(), vcurr.size(1), vcurr.size(2), Hp,
                          Wp, fx, fy, cx, cy, as_stream(stream));
}

int probe_a(const torch::Tensor& table, const torch::Tensor& idx, torch::Tensor out, int64_t stream) {
  return xs_probe_a(table.data_ptr(), idx.data_ptr(), out.data_ptr(), out.numel(), as_stream(stream));
}

int probe_b(const torch::Tensor& table, const torch::Tensor& idx, torch::Tensor out, int64_t stream) {
  return xs_probe_b(table.data_ptr(), idx.data_ptr(), out.data_ptr(), out.numel(), as_stream(stream));
}

int probe_c(const torch::Tensor& table, torch::Tensor out, int64_t stream) {
  return xs_probe_c(table.data_ptr(), out.data_ptr(), as_stream(stream));
}

int probe_d(const torch::Tensor& table, torch::Tensor out, int64_t stream) {
  return xs_probe_d(table.data_ptr(), out.data_ptr(), out.numel(), as_stream(stream));
}

int probe_e(const torch::Tensor& table, const torch::Tensor& idx0, torch::Tensor out, int64_t n_steps,
            int64_t stream) {
  return xs_probe_e(table.data_ptr(), idx0.data_ptr(), out.data_ptr(), out.numel(), table.size(0), n_steps,
                    as_stream(stream));
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("bilateral_filter", &bilateral_filter);
  m.def("fuse_volume", &fuse_volume);
  m.def("march_fixed", &march_fixed);
  m.def("icp_system", &icp_system);
  m.def("icp_associate", &icp_associate);
  m.def("probe_a", &probe_a);
  m.def("probe_b", &probe_b);
  m.def("probe_c", &probe_c);
  m.def("probe_d", &probe_d);
  m.def("probe_e", &probe_e);
}
