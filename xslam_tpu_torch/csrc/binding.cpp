// Python binding of the kernels' C entry points (bilateral.cu, fusion.cu,
// march.cu), built with them by torch.utils.cpp_extension.load. The only
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

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("bilateral_filter", &bilateral_filter);
  m.def("fuse_volume", &fuse_volume);
  m.def("march_fixed", &march_fixed);
}
