// The four kernels that lie on the exported lateral and longitudinal steps
// as operators of PyTorch's dispatcher, namespace `avp`: the fused
// preprocess (csrc/preprocess.cu, the port of the Pallas kernel
// autoware_vision_pilot_tpu/ops/pallas/preprocess_kernel.py), the
// letterbox (csrc/letterbox.cu), the lane-filter walk (csrc/lane_filter.cu)
// and the greedy NMS (csrc/nms.cu).
//
// torch.export records a call of `torch.ops.avp.*` as one node, and an
// AOTInductor package calls it back through the dispatcher by name, so a
// process with no Python runs these kernels once it has loaded this library
// (export/native_app.py, host/tools/visionpilot_app.cpp). Each operator
// allocates its outputs with at::empty and calls the kernel's C entry point
// in libavp_kernels.so on the current stream; a non-zero cudaError_t
// raises (a table or an output off the 16 bytes a kernel wants among them).
// The output type is a bool (bf16, else f32), not a ScalarType: an
// AOTInductor package passes an operator's ScalarType argument as
// torch.export's serialized enum, which the kernel would misread. The
// host-side tables (bilinear taps, mean and 1 / std) are tensor inputs, so
// an export lifts them as constants. Only a CUDA implementation
// is registered: on the CPU the Python wrappers run the plain versions
// (ops/kernels/*.py), and the fake implementations that give the output
// shapes to a trace are in ops/kernels/torch_ops.py.
//
// avp_torch_op_calls(i) counts the calls of operator i (the order of
// kAvpOps) in this process, whatever called it, and the C++ loop prints it.

#include <ATen/core/Tensor.h>
#include <ATen/ops/empty.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <torch/library.h>

#include <atomic>
#include <cstdint>
#include <optional>
#include <tuple>

extern "C" {
int avp_fused_preprocess(const void* frame, void* out, const void* y0, const void* y1,
                         const void* fy, const void* x0, const void* x1, const void* fx,
                         const void* mean, const void* inv_std, long long frame_stride, int B,
                         int H, int W, int h, int w, int out_bf16, void* stream);
int avp_letterbox(const void* frame, void* out, const void* y0, const void* y1, const void* fy,
                  const void* x0, const void* x1, const void* fx, long long frame_stride, int B,
                  int H, int W, int h, int w, int nh, int nw, int pad_y, int pad_x, int pad_bits,
                  int out_bf16, void* stream);
int avp_lane_filter_walk(const void* masks, void* weights, void* starts, int N, int H, int W,
                         void* stamps, void* stream);
int avp_nms_greedy(const void* boxes, const void* scores, const void* classes, void* out_boxes,
                   void* out_scores, void* out_classes, void* out_valid, int N, int k,
                   int max_det, float iou_thresh, float conf_thresh, int class_aware, int cs,
                   void* stamps, void* stream);
}

namespace {

enum Op { kPreprocess, kLetterbox, kWalk, kNms, kAvpOps };
std::atomic<long long> g_calls[kAvpOps];

void* stream_of(const at::Tensor& t) {
  return (void*)c10::cuda::getCurrentCUDAStream(t.device().index()).stream();
}

void check_launch(int err, const char* what) {
  TORCH_CHECK(err == 0, what, " failed: cudaError_t ", err);
}

void check_cuda(const at::Tensor& t, const char* what, at::ScalarType dtype) {
  TORCH_CHECK(t.is_cuda(), what, " must be a CUDA tensor");
  TORCH_CHECK(t.scalar_type() == dtype, what, " must be ", dtype, ", got ", t.scalar_type());
}

// frames: (B, H, W, 3) uint8, each frame contiguous and any stride apart
// (the crop frames[:, y0:] of a contiguous batch is). A batch that is not
// becomes contiguous.
at::Tensor frames_of(const at::Tensor& frames, long long* stride) {
  check_cuda(frames, "frames", at::kByte);
  TORCH_CHECK(frames.dim() == 4 && frames.size(3) == 3, "frames must be (B, H, W, 3), got ",
              frames.sizes());
  const int64_t B = frames.size(0), H = frames.size(1), W = frames.size(2);
  TORCH_CHECK(B > 0 && H > 0 && W > 0, "empty frames ", frames.sizes());
  const bool rows = (H == 1 || frames.stride(1) == 3 * W) && (W == 1 || frames.stride(2) == 3) &&
                    frames.stride(3) == 1;
  const at::Tensor f = rows && frames.stride(0) >= 0 ? frames : frames.contiguous();
  *stride = B > 1 ? f.stride(0) : H * W * 3;
  return f;
}

at::Tensor fused_preprocess(const at::Tensor& frames, const at::Tensor& y0, const at::Tensor& y1,
                            const at::Tensor& fy, const at::Tensor& x0, const at::Tensor& x1,
                            const at::Tensor& fx, const at::Tensor& mean,
                            const at::Tensor& inv_std, int64_t h, int64_t w, bool out_bf16) {
  const c10::cuda::CUDAGuard guard(frames.device());
  long long stride = 0;
  const at::Tensor f = frames_of(frames, &stride);
  const int64_t B = f.size(0), H = f.size(1), W = f.size(2);
  TORCH_CHECK(y0.numel() == h && x0.numel() == w, "taps for ", y0.numel(), "x", x0.numel(),
              ", output ", h, "x", w);
  for (const at::Tensor* t : {&y0, &y1, &x0, &x1}) check_cuda(*t, "taps", at::kInt);
  check_cuda(fy, "taps", at::kFloat);
  check_cuda(fx, "taps", at::kFloat);
  check_cuda(mean, "mean", at::kFloat);
  check_cuda(inv_std, "inv_std", at::kDouble);
  const at::Tensor t[] = {y0.contiguous(), y1.contiguous(), fy.contiguous(),
                          x0.contiguous(), x1.contiguous(), fx.contiguous(),
                          mean.contiguous(), inv_std.contiguous()};
  at::Tensor out =
      at::empty({B, h, w, 3}, f.options().dtype(out_bf16 ? at::kBFloat16 : at::kFloat));
  check_launch(avp_fused_preprocess(f.data_ptr(), out.data_ptr(), t[0].data_ptr(),
                                    t[1].data_ptr(), t[2].data_ptr(), t[3].data_ptr(),
                                    t[4].data_ptr(), t[5].data_ptr(), t[6].data_ptr(),
                                    t[7].data_ptr(), stride, (int)B, (int)H, (int)W, (int)h,
                                    (int)w, out_bf16, stream_of(f)),
               "avp_fused_preprocess");
  ++g_calls[kPreprocess];
  return out;
}

at::Tensor fused_letterbox(const at::Tensor& frames, const at::Tensor& y0, const at::Tensor& y1,
                           const at::Tensor& fy, const at::Tensor& x0, const at::Tensor& x1,
                           const at::Tensor& fx, int64_t h, int64_t w, int64_t pad_y,
                           int64_t pad_x, int64_t pad_bits, bool out_bf16) {
  const c10::cuda::CUDAGuard guard(frames.device());
  long long stride = 0;
  const at::Tensor f = frames_of(frames, &stride);
  const int64_t B = f.size(0), H = f.size(1), W = f.size(2);
  for (const at::Tensor* t : {&y0, &y1, &x0, &x1}) check_cuda(*t, "taps", at::kInt);
  check_cuda(fy, "taps", at::kFloat);
  check_cuda(fx, "taps", at::kFloat);
  const at::Tensor t[] = {y0.contiguous(), y1.contiguous(), fy.contiguous(),
                          x0.contiguous(), x1.contiguous(), fx.contiguous()};
  at::Tensor out =
      at::empty({B, h, w, 3}, f.options().dtype(out_bf16 ? at::kBFloat16 : at::kFloat));
  check_launch(avp_letterbox(f.data_ptr(), out.data_ptr(), t[0].data_ptr(), t[1].data_ptr(),
                             t[2].data_ptr(), t[3].data_ptr(), t[4].data_ptr(), t[5].data_ptr(),
                             stride, (int)B, (int)H, (int)W, (int)h, (int)w, (int)y0.numel(),
                             (int)x0.numel(), (int)pad_y, (int)pad_x, (int)pad_bits,
                             out_bf16, stream_of(f)),
               "avp_letterbox");
  ++g_calls[kLetterbox];
  return out;
}

std::tuple<at::Tensor, at::Tensor> lane_filter_walk(const at::Tensor& masks,
                                                    const std::optional<at::Tensor>& stamps) {
  check_cuda(masks, "masks", at::kFloat);
  TORCH_CHECK(masks.dim() == 4 && masks.size(3) == 3, "masks must be (N, H, W, 3), got ",
              masks.sizes());
  const c10::cuda::CUDAGuard guard(masks.device());
  const at::Tensor m = masks.contiguous();
  const int64_t N = m.size(0), H = m.size(1), W = m.size(2);
  at::Tensor weights = at::empty({N, 2, H, W}, m.options().dtype(at::kInt));
  at::Tensor starts = at::empty({N, 2, 3}, m.options().dtype(at::kInt));
  void* st = nullptr;
  if (stamps.has_value()) {
    check_cuda(*stamps, "stamps", at::kLong);
    st = stamps->data_ptr();
  }
  check_launch(avp_lane_filter_walk(m.data_ptr(), weights.data_ptr(), starts.data_ptr(), (int)N,
                                    (int)H, (int)W, st, stream_of(m)),
               "avp_lane_filter_walk");
  ++g_calls[kWalk];
  return {weights, starts};
}

std::tuple<at::Tensor, at::Tensor, at::Tensor, at::Tensor> nms_greedy(
    const at::Tensor& boxes, const at::Tensor& scores, const at::Tensor& classes,
    int64_t max_det, double iou_thresh, double conf_thresh, bool class_aware, int64_t cluster,
    const std::optional<at::Tensor>& stamps) {
  check_cuda(boxes, "boxes", at::kFloat);
  check_cuda(scores, "scores", at::kFloat);
  check_cuda(classes, "classes", at::kInt);
  TORCH_CHECK(scores.dim() == 2 && boxes.dim() == 3 && boxes.size(2) == 4 &&
                  boxes.size(0) == scores.size(0) && boxes.size(1) == scores.size(1) &&
                  classes.sizes() == scores.sizes(),
              "expected (N, k, 4), (N, k), (N, k), got ", boxes.sizes(), ", ", scores.sizes(),
              ", ", classes.sizes());
  const c10::cuda::CUDAGuard guard(boxes.device());
  const at::Tensor b = boxes.contiguous(), s = scores.contiguous(), c = classes.contiguous();
  const int64_t N = s.size(0), k = s.size(1);
  const auto opts = b.options();
  at::Tensor ob = at::empty({N, max_det, 4}, opts);
  at::Tensor os = at::empty({N, max_det}, opts);
  at::Tensor oc = at::empty({N, max_det}, opts.dtype(at::kInt));
  at::Tensor ov = at::empty({N, max_det}, opts.dtype(at::kBool));
  void* st = nullptr;
  if (stamps.has_value()) {
    check_cuda(*stamps, "stamps", at::kLong);
    st = stamps->data_ptr();
  }
  check_launch(avp_nms_greedy(b.data_ptr(), s.data_ptr(), c.data_ptr(), ob.data_ptr(),
                              os.data_ptr(), oc.data_ptr(), ov.data_ptr(), (int)N, (int)k,
                              (int)max_det, (float)iou_thresh, (float)conf_thresh, class_aware,
                              (int)cluster, st, stream_of(b)),
               "avp_nms_greedy");
  ++g_calls[kNms];
  return {ob, os, oc, ov};
}

}  // namespace

extern "C" long long avp_torch_op_calls(int op) {
  return op >= 0 && op < kAvpOps ? g_calls[op].load() : -1;
}

TORCH_LIBRARY(avp, m) {
  m.def("fused_preprocess(Tensor frames, Tensor y0, Tensor y1, Tensor fy, Tensor x0, Tensor x1, "
        "Tensor fx, Tensor mean, Tensor inv_std, int h, int w, bool out_bf16) -> Tensor");
  m.def("fused_letterbox(Tensor frames, Tensor y0, Tensor y1, Tensor fy, Tensor x0, Tensor x1, "
        "Tensor fx, int h, int w, int pad_y, int pad_x, int pad_bits, bool out_bf16) -> Tensor");
  m.def("lane_filter_walk(Tensor masks, Tensor(a!)? stamps=None) -> (Tensor, Tensor)");
  m.def("nms_greedy(Tensor boxes, Tensor scores, Tensor classes, int max_det, float iou_thresh, "
        "float conf_thresh, bool class_aware, int cluster, Tensor(a!)? stamps=None) "
        "-> (Tensor, Tensor, Tensor, Tensor)");
}

TORCH_LIBRARY_IMPL(avp, CUDA, m) {
  m.impl("fused_preprocess", &fused_preprocess);
  m.impl("fused_letterbox", &fused_letterbox);
  m.impl("lane_filter_walk", &lane_filter_walk);
  m.impl("nms_greedy", &nms_greedy);
}
