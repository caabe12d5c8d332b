// Python binding of the kernels' C entry points (bilateral.cu, fusion.cu,
// bricks.cu, march.cu, refine.cu, maps.cu, icp.cu, window.cu, skip.cu,
// gather_probes.cu), built with them by
// torch.utils.cpp_extension.load. The only
// source that includes PyTorch's headers. The wrappers in ops/kernels.py
// check device, type, shape and contiguity; each function here launches on
// the stream it is given and returns the launch's cudaError_t.

#include <torch/extension.h>

extern "C" int xs_bilateral_weights(void* table, void* stream);
extern "C" int xs_bilateral_filter(const void* src, const void* weights, void* dst, int H, int W, void* stream);
extern "C" int xs_fuse_volume(void* value, void* grad, void* weight, const void* depth, const void* pose,
                              int X, int Y, int Z, int H, int W,
                              float vs, float fx, float fy, float cx, float cy,
                              float inv_fx, float inv_fy, float trunc, float inv_trunc, float max_w,
                              void* stream);
extern "C" int xs_depth_mips(const void* depth, void* table, int H, int W, const int* levels, int n_levels, int rows,
                             void* stream);
extern "C" int xs_classify_bricks(const void* table, const void* pose, void* cls, void* scratch,
                                  long long scratch_words, unsigned ticket_base, unsigned long long epoch,
                                  void* rank, void* active_ids, void* work_ids, void* totals, void* overflow,
                                  int nbx, int nby, int nbz, int H, int W, const int* levels, int n_levels,
                                  int rows, const float* consts, int cap, void* stream);
extern "C" int xs_fuse_bricks(void* value, void* grad, void* weight, const void* depth, const void* pose,
                              const void* cls, const void* rank, const void* work_ids, const void* totals,
                              const void* overflow, int X, int Y, int Z, int H, int W, float vs, float fx, float fy,
                              float cx, float cy, float inv_fx, float inv_fy, float trunc, float inv_trunc,
                              float max_w, int cap, int dense_on_overflow, int rows, void* stream);
extern "C" int xs_window_march(const void* value, const void* grad, const void* pose, const void* anchor,
                               const void* anchor_dead, void* vmap_v, void* vmap_g, void* t_found, void* t_dead,
                               int nbx, int nby, int nbz, int H, int W, int ch, int cw, int stride, int window,
                               float vs, float inv_vs, float step, float inv_step, float cx, float cy, float inv_fx,
                               float inv_fy, void* stream);
extern "C" int xs_skip_field(const void* value, const void* weight, void* mask, void* dist, int nbx, int nby, int nbz,
                             void* stream);
extern "C" int xs_march_skip(const void* value, const void* dist, const void* pose, void* t_found, void* t_dead,
                             int nbx, int nby, int nbz, int H, int W, int stride, int n_steps, float vs, float inv_vs,
                             float step, float steps_per_cell, float cx, float cy, float inv_fx, float inv_fy,
                             void* stream);
extern "C" int xs_march_fixed(const void* value, const void* pose, void* t_found, void* t_dead, int X, int Y,
                              int Z, int H, int W, int n_steps, float vs, float step, float cx, float cy,
                              float inv_fx, float inv_fy, void* stream);
extern "C" int xs_march_fixed_chain(const void* value, const void* start, const void* dirs, void* t_found,
                                    void* t_dead, int X, int Y, int Z, int H, int W, int n_steps, float vs,
                                    float step, void* stream);
extern "C" int xs_raycast_refine(const void* value, const void* grad, const void* pose, const void* t_found,
                                 const void* t_dead, void* vmap_v, void* vmap_g, void* nmap_v, void* nmap_g,
                                 void* direct, int X, int Y, int Z, int H, int W, float vs, float inv_vs,
                                 float half_vs, float step, float cx, float cy, float inv_fx, float inv_fy,
                                 void* stream);
extern "C" int xs_model_map_pyramid(const void* const* in, void* out, const long long* offsets, int levels, int H,
                                    int W, void* stream);
extern "C" int xs_model_map_normals(const void* vmap_v, const void* vmap_g, void* nmap_v, void* nmap_g, void* out,
                                    const long long* offsets, int levels, int H, int W, void* stream);
extern "C" int xs_depth_pyramid(const void* src, void* l1, void* l2, int H, int W, int levels, void* stream);
extern "C" int xs_vertex_normal_maps(const void* const* depths, const int* H, const int* W, void* out,
                                     const long long* offsets, const float* cams, int levels, void* stream);
extern "C" int xs_icp_system(const void* vcurr, const void* ncurr, const void* rows, const void* assoc,
                             void* assoc_out, const void* pose, void* partials, void* ticket, int blocks, void* out,
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

int bilateral_weights(torch::Tensor table, int64_t stream) {
  return xs_bilateral_weights(table.data_ptr(), as_stream(stream));
}

// weights: the table of bilateral_weights
int bilateral_filter(const torch::Tensor& depth, const torch::Tensor& weights, torch::Tensor out, int64_t stream) {
  return xs_bilateral_filter(depth.data_ptr(), weights.data_ptr(), out.data_ptr(), depth.size(0), depth.size(1),
                             as_stream(stream));
}

int fuse_volume(torch::Tensor value, torch::Tensor grad, torch::Tensor weight, const torch::Tensor& depth,
                const torch::Tensor& pose, float vs, float fx, float fy, float cx, float cy, float inv_fx,
                float inv_fy, float trunc, float inv_trunc, float max_w, int64_t stream) {
  return xs_fuse_volume(value.data_ptr(), grad.data_ptr(), weight.data_ptr(), depth.data_ptr(), pose.data_ptr(),
                        value.size(0), value.size(1), value.size(2), depth.size(0), depth.size(1),
                        vs, fx, fy, cx, cy, inv_fx, inv_fy, trunc, inv_trunc, max_w, as_stream(stream));
}

// levels: 4 ints a mip level (tile size, tiles down, tiles across, first row of the table)
int depth_mips(const torch::Tensor& depth, torch::Tensor table, const std::vector<int64_t>& levels, int64_t stream) {
  if (levels.size() % 4 != 0) return 1;  // cudaErrorInvalidValue
  const std::vector<int> lv(levels.begin(), levels.end());
  return xs_depth_mips(depth.data_ptr(), table.data_ptr(), depth.size(0), depth.size(1), lv.data(),
                       (int)(lv.size() / 4), table.size(0), as_stream(stream));
}

// cls: (nbx, nby, nbz); scratch: ops/fusion_brick.py::ClassifyScratch's int64 words; ticket_base, epoch:
// the tickets its earlier launches took (mod 2^32) and this launch's number on it, from 1; rank,
// active_ids, work_ids: one int a brick; totals: (2,) int32; overflow: () bool; consts: the classifier's
// thirteen float32 constants
int classify_bricks(const torch::Tensor& table, const torch::Tensor& pose, torch::Tensor cls, torch::Tensor scratch,
                    int64_t ticket_base, int64_t epoch, torch::Tensor rank, torch::Tensor active_ids,
                    torch::Tensor work_ids, torch::Tensor totals, torch::Tensor overflow, int64_t H, int64_t W,
                    const std::vector<int64_t>& levels, const std::vector<double>& consts, int64_t cap,
                    int64_t stream) {
  if (levels.size() % 4 != 0 || consts.size() != 13 || epoch < 1) return 1;  // cudaErrorInvalidValue
  const std::vector<int> lv(levels.begin(), levels.end());
  const std::vector<float> c(consts.begin(), consts.end());  // float32 values, carried exactly in double
  return xs_classify_bricks(table.data_ptr(), pose.data_ptr(), cls.data_ptr(), scratch.data_ptr(), scratch.numel(),
                            (unsigned)(ticket_base & 0xffffffffll), (unsigned long long)epoch,
                            rank.data_ptr(), active_ids.data_ptr(), work_ids.data_ptr(), totals.data_ptr(),
                            overflow.data_ptr(), cls.size(0), cls.size(1), cls.size(2), H, W, lv.data(),
                            (int)(lv.size() / 4), table.size(0), c.data(), cap, as_stream(stream));
}

// res: the volume's (X, Y, Z); rows: the planes are its (NB, 512) brick rows, not (X, Y, Z) planes
int fuse_bricks(torch::Tensor value, torch::Tensor grad, torch::Tensor weight, const torch::Tensor& depth,
                const torch::Tensor& pose, const torch::Tensor& cls, const torch::Tensor& rank,
                const torch::Tensor& work_ids, const torch::Tensor& totals, const torch::Tensor& overflow, float vs,
                float fx, float fy, float cx, float cy, float inv_fx, float inv_fy, float trunc, float inv_trunc,
                float max_w, int64_t cap, bool dense_on_overflow, const std::vector<int64_t>& res, bool rows,
                int64_t stream) {
  if (res.size() != 3) return 1;  // cudaErrorInvalidValue
  return xs_fuse_bricks(value.data_ptr(), grad.data_ptr(), weight.data_ptr(), depth.data_ptr(), pose.data_ptr(),
                        cls.data_ptr(), rank.data_ptr(), work_ids.data_ptr(), totals.data_ptr(), overflow.data_ptr(),
                        res[0], res[1], res[2], depth.size(0), depth.size(1), vs, fx, fy, cx, cy, inv_fx, inv_fy,
                        trunc, inv_trunc, max_w, cap, dense_on_overflow ? 1 : 0, rows ? 1 : 0, as_stream(stream));
}

// mask: NB bytes of scratch; dist: the (NB,) int32 distances out
int skip_field(const torch::Tensor& value, const torch::Tensor& weight, torch::Tensor mask, torch::Tensor dist,
               int64_t nbx, int64_t nby, int64_t nbz, int64_t stream) {
  return xs_skip_field(value.data_ptr(), weight.data_ptr(), mask.data_ptr(), dist.data_ptr(), nbx, nby, nbz,
                       as_stream(stream));
}

int march_skip(const torch::Tensor& value, const torch::Tensor& dist, const torch::Tensor& pose, torch::Tensor t_found,
               torch::Tensor t_dead, int64_t nbx, int64_t nby, int64_t nbz, int64_t stride, int64_t n_steps, float vs,
               float inv_vs, float step, float steps_per_cell, float cx, float cy, float inv_fx, float inv_fy,
               int64_t stream) {
  return xs_march_skip(value.data_ptr(), dist.data_ptr(), pose.data_ptr(), t_found.data_ptr(), t_dead.data_ptr(), nbx,
                       nby, nbz, t_found.size(0), t_found.size(1), stride, n_steps, vs, inv_vs, step, steps_per_cell,
                       cx, cy, inv_fx, inv_fy, as_stream(stream));
}

int march_fixed(const torch::Tensor& value, const torch::Tensor& pose, torch::Tensor t_found, torch::Tensor t_dead,
                int64_t n_steps, float vs, float step, float cx, float cy, float inv_fx, float inv_fy,
                int64_t stream) {
  return xs_march_fixed(value.data_ptr(), pose.data_ptr(), t_found.data_ptr(), t_dead.data_ptr(), value.size(0),
                        value.size(1), value.size(2), t_found.size(0), t_found.size(1), n_steps, vs, step, cx, cy,
                        inv_fx, inv_fy, as_stream(stream));
}

int march_fixed_chain(const torch::Tensor& value, const torch::Tensor& start, const torch::Tensor& dirs,
                      torch::Tensor t_found, torch::Tensor t_dead, int64_t n_steps, float vs, float step,
                      int64_t stream) {
  return xs_march_fixed_chain(value.data_ptr(), start.data_ptr(), dirs.data_ptr(), t_found.data_ptr(),
                              t_dead.data_ptr(), value.size(0), value.size(1), value.size(2), t_found.size(0),
                              t_found.size(1), n_steps, vs, step, as_stream(stream));
}

void* data_or_null(const std::optional<torch::Tensor>& t) { return t.has_value() ? t->data_ptr() : nullptr; }

// anchor, anchor_dead: the coarse hits, or anchor_dead None and anchor the map to pool; vmap_v, vmap_g: the
// refine's (3, H, W) outputs, or None for the march alone (then t_dead is written)
int window_march(const torch::Tensor& value, const torch::Tensor& grad, const torch::Tensor& pose,
                 const torch::Tensor& anchor, const std::optional<torch::Tensor>& anchor_dead,
                 const std::optional<torch::Tensor>& vmap_v, const std::optional<torch::Tensor>& vmap_g,
                 torch::Tensor t_found, const std::optional<torch::Tensor>& t_dead, int64_t nbx, int64_t nby,
                 int64_t nbz, int64_t H, int64_t W, int64_t ch, int64_t cw, int64_t stride, int64_t window, float vs,
                 float inv_vs, float step, float inv_step, float cx, float cy, float inv_fx, float inv_fy,
                 int64_t stream) {
  return xs_window_march(value.data_ptr(), grad.data_ptr(), pose.data_ptr(), anchor.data_ptr(),
                         data_or_null(anchor_dead), data_or_null(vmap_v), data_or_null(vmap_g), t_found.data_ptr(),
                         data_or_null(t_dead), nbx, nby, nbz, H, W, ch, cw, stride, window, vs, inv_vs, step,
                         inv_step, cx, cy, inv_fx, inv_fy, as_stream(stream));
}

// vmap_v, vmap_g, nmap_v, nmap_g: the (3, H, W) outputs; direct: an int32 counter of the normal samples read
// directly, or None
int raycast_refine(const torch::Tensor& value, const torch::Tensor& grad, const torch::Tensor& pose,
                   const torch::Tensor& t_found, const torch::Tensor& t_dead, torch::Tensor vmap_v,
                   torch::Tensor vmap_g, torch::Tensor nmap_v, torch::Tensor nmap_g,
                   const std::optional<torch::Tensor>& direct, float vs, float inv_vs, float half_vs, float step,
                   float cx, float cy, float inv_fx, float inv_fy, int64_t stream) {
  return xs_raycast_refine(value.data_ptr(), grad.data_ptr(), pose.data_ptr(), t_found.data_ptr(),
                           t_dead.data_ptr(), vmap_v.data_ptr(), vmap_g.data_ptr(), nmap_v.data_ptr(),
                           nmap_g.data_ptr(), data_or_null(direct), value.size(0), value.size(1), value.size(2),
                           t_found.size(0), t_found.size(1), vs, inv_vs, half_vs, step, cx, cy, inv_fx, inv_fy,
                           as_stream(stream));
}

// level 0's maps in (v.v, v.g, n.v, n.g, each (3, H, W)); out: the buffer of the coarser levels' maps;
// offsets: four a coarser level, in floats
int model_map_pyramid(const torch::Tensor& vv, const torch::Tensor& vg, const torch::Tensor& nv,
                      const torch::Tensor& ng, torch::Tensor out, const std::vector<int64_t>& offsets, int64_t levels,
                      int64_t stream) {
  if ((int64_t)offsets.size() != 4 * (levels - 1)) return 1;  // cudaErrorInvalidValue
  const void* in[4] = {vv.data_ptr(), vg.data_ptr(), nv.data_ptr(), ng.data_ptr()};
  const std::vector<long long> offs(offsets.begin(), offsets.end());
  return xs_model_map_pyramid(in, out.data_ptr(), offs.data(), (int)levels, vv.size(1), vv.size(2),
                              as_stream(stream));
}

// level 0's vertex map in (v.v, v.g, each (3, H, W)), its screen normals out (n.v, n.g); out, offsets: the
// coarser levels' maps as above
int model_map_normals(const torch::Tensor& vv, const torch::Tensor& vg, torch::Tensor nv, torch::Tensor ng,
                      torch::Tensor out, const std::vector<int64_t>& offsets, int64_t levels, int64_t stream) {
  if ((int64_t)offsets.size() != 4 * (levels - 1)) return 1;  // cudaErrorInvalidValue
  const std::vector<long long> offs(offsets.begin(), offsets.end());
  return xs_model_map_normals(vv.data_ptr(), vg.data_ptr(), nv.data_ptr(), ng.data_ptr(), out.data_ptr(), offs.data(),
                              (int)levels, vv.size(1), vv.size(2), as_stream(stream));
}

// l1, l2: the (H / 2, W / 2) and (H / 4, W / 4) outputs (l2 unused with 2 levels)
// l2: the level-2 output with 3 levels, None with 2
int depth_pyramid(const torch::Tensor& src, torch::Tensor l1, std::optional<torch::Tensor> l2, int64_t levels,
                  int64_t stream) {
  return xs_depth_pyramid(src.data_ptr(), l1.data_ptr(), l2 ? l2->data_ptr() : nullptr, src.size(0), src.size(1),
                          (int)levels, as_stream(stream));
}

// depths: the (H, W) depth of each level; out: the buffer of all the maps; offsets: two a level (vertex map,
// normal map), in floats; cams: four a level (cx, cy, 1 / fx, 1 / fy)
int vertex_normal_maps(const std::vector<torch::Tensor>& depths, torch::Tensor out,
                       const std::vector<int64_t>& offsets, const std::vector<double>& cams, int64_t stream) {
  const size_t levels = depths.size();
  if (offsets.size() != 2 * levels || cams.size() != 4 * levels) return 1;  // cudaErrorInvalidValue
  std::vector<const void*> ptrs;
  std::vector<int> H, W;
  for (const auto& d : depths) {
    ptrs.push_back(d.data_ptr());
    H.push_back(d.size(0));
    W.push_back(d.size(1));
  }
  const std::vector<long long> offs(offsets.begin(), offsets.end());
  const std::vector<float> cam(cams.begin(), cams.end());  // float32 values, carried exactly in double
  return xs_vertex_normal_maps(ptrs.data(), H.data(), W.data(), out.data_ptr(), offs.data(), cam.data(),
                               (int)levels, as_stream(stream));
}

// assoc: the cached int32 index map, or None to project in the kernel; assoc_out: where a projecting launch
// writes the index map it makes, or None.
// pose_out, x_out, flags: the tail's outputs, or None to stop after A and b.
int icp_system(const torch::Tensor& vcurr, const torch::Tensor& ncurr, const torch::Tensor& rows,
               const std::optional<torch::Tensor>& assoc, const std::optional<torch::Tensor>& assoc_out,
               const torch::Tensor& pose, torch::Tensor partials,
               torch::Tensor ticket, int64_t blocks, torch::Tensor out, torch::Tensor inliers,
               const std::optional<torch::Tensor>& pose_out, const std::optional<torch::Tensor>& x_out,
               const std::optional<torch::Tensor>& flags, float damping, bool first, int64_t Hp, int64_t Wp,
               float fx, float fy, float cx, float cy, float dist_thres, float angle_thres, int64_t stream) {
  return xs_icp_system(vcurr.data_ptr(), ncurr.data_ptr(), rows.data_ptr(), data_or_null(assoc),
                       data_or_null(assoc_out), pose.data_ptr(),
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
  m.def("bilateral_weights", &bilateral_weights);
  m.def("bilateral_filter", &bilateral_filter);
  m.def("fuse_volume", &fuse_volume);
  m.def("depth_mips", &depth_mips);
  m.def("classify_bricks", &classify_bricks);
  m.def("fuse_bricks", &fuse_bricks);
  m.def("window_march", &window_march);
  m.def("skip_field", &skip_field);
  m.def("march_skip", &march_skip);
  m.def("march_fixed", &march_fixed);
  m.def("march_fixed_chain", &march_fixed_chain);
  m.def("raycast_refine", &raycast_refine);
  m.def("model_map_pyramid", &model_map_pyramid);
  m.def("model_map_normals", &model_map_normals);
  m.def("depth_pyramid", &depth_pyramid);
  m.def("vertex_normal_maps", &vertex_normal_maps);
  m.def("icp_system", &icp_system);
  m.def("icp_associate", &icp_associate);
  m.def("probe_a", &probe_a);
  m.def("probe_b", &probe_b);
  m.def("probe_c", &probe_c);
  m.def("probe_d", &probe_d);
  m.def("probe_e", &probe_e);
}
