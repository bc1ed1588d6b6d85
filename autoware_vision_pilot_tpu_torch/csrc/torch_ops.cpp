// The port's kernels as operators of PyTorch's dispatcher, namespace `avp`:
// the fused preprocess (csrc/preprocess.cu, the port of the Pallas kernel
// autoware_vision_pilot_tpu/ops/pallas/preprocess_kernel.py), the
// letterbox (csrc/letterbox.cu), the lane-filter walk (csrc/lane_filter.cu),
// the greedy NMS (csrc/nms.cu), and the int8 kernels (the port of the int8
// branches of autoware_vision_pilot_tpu/nn/layers.py's Conv2d and
// ConvTranspose2d): the activation quantize (csrc/int8_conv.cu), the conv
// on each route of ops/kernels/int8_conv.py::int8_conv_plan ("wgmma" and
// "splitk" on csrc/int8_conv_sm90.cu, "strided" on csrc/int8_conv_strided.cu,
// "halo" on csrc/int8_conv_halo.cu, "pointwise" and "dot" on
// csrc/int8_pointwise.cu)
// and the transposed conv's "d2s" product (csrc/int8_conv_sm90.cu).
//
// torch.export records a call of `torch.ops.avp.*` as one node, and an
// AOTInductor package calls it back through the dispatcher by name, so a
// process with no Python runs these kernels once it has loaded this library
// (export/native_app.py, host/tools/visionpilot_app.cpp). Each operator
// allocates its outputs with at::empty and calls the kernel's C entry point
// in libavp_kernels.so on the current stream; a non-zero cudaError_t
// raises (a table or an output off the 16 bytes a kernel wants among them).
// The output type is a bool (bf16, else f32), or for the int8 convs an int
// (0 f32, 1 bf16, 2 the int32 accumulators), not a ScalarType: an
// AOTInductor package passes an operator's ScalarType argument as
// torch.export's serialized enum, which the kernel would misread. The
// host-side tables (bilinear taps, mean and 1 / std) are tensor inputs, so
// an export lifts them as constants. Only a CUDA implementation
// is registered: on the CPU the Python wrappers run the plain versions
// (ops/kernels/*.py), and the fake implementations that give the output
// shapes to a trace are in ops/kernels/torch_ops.py.
//
// The int8 operators take the plan's integers (ops/kernels/int8_conv.py
// picks them in Python from the static shapes, at trace time in an export)
// and the weights themselves: the kernels' entry points encode the input's
// TMA map at each call and the weights' once per (address, shape, box)
// (csrc/sm90.cuh::weight_map). A split-K launch's workspace comes from
// at::empty (the wgmma kernel's; the strided kernel sums its K splits
// inside a cluster and needs none). Their tensors must lie as the kernels read them (NHWC:
// channels_last; checked, never copied), and they are tagged
// needs_fixed_stride_order so that inductor hands them the strides eager
// does. The 1x1 routes on a float input quantize as they load with 1 /
// x_scale in float64 (x_rcp), which the caller computes (a graph records
// it); on an int8 input they take none.
//
// avp_torch_op_calls(i) counts the calls of operator i (the order of
// kAvpOps) in this process, whatever called it, and the C++ loop prints it.

#include <ATen/core/Tensor.h>
#include <ATen/ops/empty.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <torch/library.h>

#include <array>
#include <atomic>
#include <cstdint>
#include <optional>
#include <string>
#include <tuple>
#include <vector>

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
int avp_int8_quantize(const void* x, void* xq, const void* scale, int per_channel,
                      long long pixels, int C, int in_bf16, void* stream);
int avp_int8_conv_wgmma(const void* xq, const void* w, const void* w_scale, const void* x_scale,
                        const void* bias, void* out, void* ws, int B, int H, int W, int C, int N,
                        int KH, int KW, int pad_h, int pad_w, int out_kind, int th, int tw,
                        int m_tiles, int n_tiles, int splits, int per_split, int blocks,
                        void* stream);
int avp_int8_conv_strided(const void* xq, const void* w, const void* w_scale,
                          const void* x_scale, const void* bias, void* out, int B, int H, int W,
                          int C, int N, int KH, int KW, int pad_h, int pad_w, int stride_h,
                          int stride_w, int dil_h, int dil_w, int out_kind, int th, int tw,
                          int bn, int m_tiles, int n_tiles, int cs, int per_rank, int stages,
                          int phase_h, int phase_w, int gu, void* stream);
int avp_int8_conv_halo(const void* xq, const void* w, const void* w_scale, const void* x_scale,
                       const void* bias, void* out, int B, int H, int W, int C, int N, int KH,
                       int KW, int pad, int out_kind, int th, int tw, int bn, int m_tiles,
                       int n_tiles, int blocks, int hstages, int resident, void* stream);
int avp_int8_conv_pointwise(const void* x, int in_kind, const void* scale, const void* rcp,
                            int per_channel, const void* w, const void* w_scale,
                            const void* bias, void* out, int M, int C, int N, int out_kind,
                            int bm, int bn, int m_tiles, int n_tiles, int cs, int k_per_rank,
                            void* stream);
int avp_int8_conv_dot(const void* x, int in_kind, const void* scale, const void* rcp,
                      int per_channel, const void* w, const void* w_scale, const void* bias,
                      void* out, int M, int C, int N, int out_kind, int lanes, void* stream);
int avp_int8_conv_d2s(const void* xq, const void* wt, const void* w_scale, const void* x_scale,
                      const void* bias, void* out, void* ws, int B, int h, int w, int C, int O,
                      int kh, int kw, int out_kind, int th, int tw, int m_tiles, int n_tiles,
                      int splits, int per_split, int blocks, int tma_store, void* stream);
}

namespace {

enum Op {
  kPreprocess, kLetterbox, kWalk, kNms,
  kInt8Quantize, kInt8Wgmma, kInt8SplitK, kInt8Strided, kInt8Halo, kInt8Pointwise, kInt8Dot,
  kInt8D2s,
  kAvpOps
};
std::atomic<long long> g_calls[kAvpOps];

void* stream_of(const at::Tensor& t) {
  return (void*)c10::cuda::getCurrentCUDAStream(t.device().index()).stream();
}

void check_launch(int err, const char* what) {
  TORCH_CHECK(err < 100000, what, ": the driver refused a tensor map, CUresult ", err - 100000);
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

// ------------------------------------------------------------------ int8

const at::ScalarType kOutTypes[3] = {at::kFloat, at::kBFloat16, at::kInt};

at::ScalarType out_type(int64_t out_kind) {
  TORCH_CHECK(out_kind >= 0 && out_kind <= 2, "out_kind must be 0 (f32), 1 (bf16) or 2 (int32), got ",
              out_kind);
  return kOutTypes[out_kind];
}

// A 4-D NCHW tensor in channels_last memory (NHWC), as the kernels read it.
void check_nhwc(const at::Tensor& t, const char* what) {
  TORCH_CHECK(t.is_cuda(), what, " must be a CUDA tensor");
  TORCH_CHECK(t.dim() == 4 && t.is_contiguous(at::MemoryFormat::ChannelsLast), what,
              " must be 4-D and channels_last contiguous, got sizes ", t.sizes(), " strides ",
              t.strides());
}

// w_scale (N,) f32, x_scale () or (C,) f32, bias (N,) of the output type
// (unless the output is the accumulators), all on x's device and contiguous.
void check_epilogue(const at::Tensor& x, const at::Tensor& w_scale, const at::Tensor& x_scale,
                    const std::optional<at::Tensor>& bias, int64_t C, int64_t N,
                    int64_t out_kind) {
  check_cuda(w_scale, "w_scale", at::kFloat);
  check_cuda(x_scale, "x_scale", at::kFloat);
  TORCH_CHECK(w_scale.dim() == 1 && w_scale.size(0) == N && w_scale.is_contiguous(),
              "w_scale must be (", N, ",) contiguous, got ", w_scale.sizes());
  TORCH_CHECK((x_scale.dim() == 0 || (x_scale.dim() == 1 && x_scale.size(0) == C)) &&
                  x_scale.is_contiguous(),
              "x_scale must be () or (", C, ",), got ", x_scale.sizes());
  TORCH_CHECK(w_scale.device() == x.device() && x_scale.device() == x.device(),
              "x and the scales must be on one device");
  if (bias.has_value() && out_kind != 2) {
    check_cuda(*bias, "bias", out_type(out_kind));
    TORCH_CHECK(bias->dim() == 1 && bias->size(0) == N && bias->is_contiguous(),
                "bias must be (", N, ",) contiguous, got ", bias->sizes());
  }
}

const void* bias_ptr(const std::optional<at::Tensor>& bias, int64_t out_kind) {
  return bias.has_value() && out_kind != 2 ? bias->data_ptr() : nullptr;
}

// (B, N, OH, OW) in channels_last memory
at::Tensor nhwc_empty(const at::Tensor& like, int64_t B, int64_t N, int64_t OH, int64_t OW,
                      at::ScalarType type) {
  return at::empty({B, N, OH, OW},
                   like.options().dtype(type).memory_format(at::MemoryFormat::ChannelsLast));
}

at::Tensor int8_quantize(const at::Tensor& x, const at::Tensor& scale) {
  check_nhwc(x, "x");
  TORCH_CHECK(x.scalar_type() == at::kFloat || x.scalar_type() == at::kBFloat16,
              "x must be f32 or bf16, got ", x.scalar_type());
  const int64_t B = x.size(0), C = x.size(1), H = x.size(2), W = x.size(3);
  check_cuda(scale, "x_scale", at::kFloat);
  TORCH_CHECK((scale.dim() == 0 || (scale.dim() == 1 && scale.size(0) == C)) &&
                  scale.is_contiguous(),
              "x_scale must be () or (", C, ",), got ", scale.sizes());
  const c10::cuda::CUDAGuard guard(x.device());
  at::Tensor xq = nhwc_empty(x, B, C, H, W, at::kChar);
  check_launch(avp_int8_quantize(x.data_ptr(), xq.data_ptr(), scale.data_ptr(), scale.dim() == 1,
                                 (long long)B * H * W, (int)C, x.scalar_type() == at::kBFloat16,
                                 stream_of(x)),
               "avp_int8_quantize");
  ++g_calls[kInt8Quantize];
  return xq;
}

// The input checks of the window convs: xq and weight int8 NHWC, the
// weight's C that of xq, the epilogue's tensors. -> (B, C, H, W, N, KH, KW).
std::array<int64_t, 7> check_window_conv(const at::Tensor& xq, const at::Tensor& weight,
                                         const at::Tensor& w_scale, const at::Tensor& x_scale,
                                         const std::optional<at::Tensor>& bias,
                                         int64_t out_kind) {
  check_nhwc(xq, "xq");
  check_nhwc(weight, "weight");
  TORCH_CHECK(xq.scalar_type() == at::kChar && weight.scalar_type() == at::kChar,
              "xq and weight must be int8");
  const int64_t C = xq.size(1), N = weight.size(0);
  TORCH_CHECK(weight.size(1) == C, "weight ", weight.sizes(), " does not take ", C, " channels");
  check_epilogue(xq, w_scale, x_scale, bias, C, N, out_kind);
  return {xq.size(0), C, xq.size(2), xq.size(3), N, weight.size(2), weight.size(3)};
}

// The wgmma kernel: "wgmma" and "splitk" (counted as `op`), stride 1.
// geometry: pad_h, pad_w, stride_h, stride_w, dil_h, dil_w (strides and
// dilations 1); plan: th, tw, m_tiles, n_tiles, splits, per_split, blocks.
at::Tensor int8_conv_wg(Op op, const char* name, const at::Tensor& xq, const at::Tensor& weight,
                        const at::Tensor& w_scale, const at::Tensor& x_scale,
                        const std::optional<at::Tensor>& bias, at::IntArrayRef geometry,
                        at::IntArrayRef plan, int64_t out_kind) {
  const auto [B, C, H, W, N, KH, KW] =
      check_window_conv(xq, weight, w_scale, x_scale, bias, out_kind);
  TORCH_CHECK(geometry.size() == 6 && plan.size() == 7, name,
              ": geometry (pad_h, pad_w, stride_h, stride_w, dil_h, dil_w) and plan (th, tw, "
              "m_tiles, n_tiles, splits, per_split, blocks), got ", geometry, ", ", plan);
  const int64_t ph = geometry[0], pw = geometry[1];
  TORCH_CHECK(ph >= 0 && pw >= 0 && geometry[2] == 1 && geometry[3] == 1 && geometry[4] == 1 &&
                  geometry[5] == 1,
              name, ": stride 1 and dilation 1 only (the strided route takes the others), got ",
              geometry);
  const int64_t OH = H + 2 * ph - KH + 1, OW = W + 2 * pw - KW + 1;
  TORCH_CHECK(OH > 0 && OW > 0, name, ": the window is larger than the padded input");
  const int64_t splits = plan[4];
  const c10::cuda::CUDAGuard guard(xq.device());
  at::Tensor out = nhwc_empty(xq, B, N, OH, OW, out_type(out_kind));
  // split-K: each split's (M, N) partial sums, then one arrival counter a tile
  at::Tensor ws;
  if (splits > 1)
    ws = at::empty({splits * B * OH * OW * N + plan[2] * plan[3]}, xq.options().dtype(at::kInt));
  check_launch(avp_int8_conv_wgmma(
                   xq.data_ptr(), weight.data_ptr(), w_scale.data_ptr(),
                   x_scale.dim() == 0 ? x_scale.data_ptr() : nullptr, bias_ptr(bias, out_kind),
                   out.data_ptr(), splits > 1 ? ws.data_ptr() : nullptr, (int)B, (int)H, (int)W,
                   (int)C, (int)N, (int)KH, (int)KW, (int)ph, (int)pw, (int)out_kind,
                   (int)plan[0], (int)plan[1], (int)plan[2], (int)plan[3], (int)splits,
                   (int)plan[5], (int)plan[6], stream_of(xq)),
               name);
  ++g_calls[op];
  return out;
}

at::Tensor int8_conv_wgmma(const at::Tensor& xq, const at::Tensor& weight,
                           const at::Tensor& w_scale, const at::Tensor& x_scale,
                           const std::optional<at::Tensor>& bias, at::IntArrayRef geometry,
                           at::IntArrayRef plan, int64_t out_kind) {
  return int8_conv_wg(kInt8Wgmma, "avp::int8_conv_wgmma", xq, weight, w_scale, x_scale, bias,
                      geometry, plan, out_kind);
}

at::Tensor int8_conv_splitk(const at::Tensor& xq, const at::Tensor& weight,
                            const at::Tensor& w_scale, const at::Tensor& x_scale,
                            const std::optional<at::Tensor>& bias, at::IntArrayRef geometry,
                            at::IntArrayRef plan, int64_t out_kind) {
  return int8_conv_wg(kInt8SplitK, "avp::int8_conv_splitk", xq, weight, w_scale, x_scale, bias,
                      geometry, plan, out_kind);
}

// The strided kernel (csrc/int8_conv_strided.cu): one launch, no
// workspace. geometry: pad_h, pad_w, stride_h, stride_w, dil_h, dil_w;
// plan: th, tw, bn, m_tiles, n_tiles, cs, per_rank, stages, phase_h,
// phase_w, gu.
at::Tensor int8_conv_strided(const at::Tensor& xq, const at::Tensor& weight,
                             const at::Tensor& w_scale, const at::Tensor& x_scale,
                             const std::optional<at::Tensor>& bias, at::IntArrayRef geometry,
                             at::IntArrayRef plan, int64_t out_kind) {
  const auto [B, C, H, W, N, KH, KW] =
      check_window_conv(xq, weight, w_scale, x_scale, bias, out_kind);
  TORCH_CHECK(geometry.size() == 6 && plan.size() == 11,
              "avp::int8_conv_strided: geometry (pad_h, pad_w, stride_h, stride_w, dil_h, dil_w) "
              "and plan (th, tw, bn, m_tiles, n_tiles, cs, per_rank, stages, phase_h, phase_w, "
              "gu), got ", geometry, ", ", plan);
  const int64_t ph = geometry[0], pw = geometry[1], sh = geometry[2], sw = geometry[3],
                dh = geometry[4], dw = geometry[5];
  TORCH_CHECK(sh > 0 && sw > 0 && dh > 0 && dw > 0 && ph >= 0 && pw >= 0,
              "avp::int8_conv_strided: bad geometry ", geometry);
  TORCH_CHECK(H + 2 * ph - dh * (KH - 1) > 0 && W + 2 * pw - dw * (KW - 1) > 0,
              "avp::int8_conv_strided: the window is larger than the padded input");
  const int64_t OH = (H + 2 * ph - dh * (KH - 1) - 1) / sh + 1;
  const int64_t OW = (W + 2 * pw - dw * (KW - 1) - 1) / sw + 1;
  const c10::cuda::CUDAGuard guard(xq.device());
  at::Tensor out = nhwc_empty(xq, B, N, OH, OW, out_type(out_kind));
  int p[11];
  for (int i = 0; i < 11; ++i) p[i] = (int)plan[i];
  check_launch(avp_int8_conv_strided(
                   xq.data_ptr(), weight.data_ptr(), w_scale.data_ptr(),
                   x_scale.dim() == 0 ? x_scale.data_ptr() : nullptr, bias_ptr(bias, out_kind),
                   out.data_ptr(), (int)B, (int)H, (int)W, (int)C, (int)N, (int)KH, (int)KW,
                   (int)ph, (int)pw, (int)sh, (int)sw, (int)dh, (int)dw, (int)out_kind, p[0],
                   p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8], p[9], p[10], stream_of(xq)),
               "avp::int8_conv_strided");
  ++g_calls[kInt8Strided];
  return out;
}

// plan: th, tw, bn, m_tiles, n_tiles, blocks, stages, resident
at::Tensor int8_conv_halo(const at::Tensor& xq, const at::Tensor& weight,
                          const at::Tensor& w_scale, const at::Tensor& x_scale,
                          const std::optional<at::Tensor>& bias, int64_t pad,
                          at::IntArrayRef plan, int64_t out_kind) {
  const auto [B, C, H, W, N, KH, KW] =
      check_window_conv(xq, weight, w_scale, x_scale, bias, out_kind);
  TORCH_CHECK(plan.size() == 8, "avp::int8_conv_halo: plan (th, tw, bn, m_tiles, n_tiles, "
              "blocks, stages, resident), got ", plan);
  const int64_t OH = H + 2 * pad - KH + 1, OW = W + 2 * pad - KW + 1;
  TORCH_CHECK(pad >= 0 && OH > 0 && OW > 0, "avp::int8_conv_halo: the window is larger than "
              "the padded input");
  const c10::cuda::CUDAGuard guard(xq.device());
  at::Tensor out = nhwc_empty(xq, B, N, OH, OW, out_type(out_kind));
  check_launch(avp_int8_conv_halo(xq.data_ptr(), weight.data_ptr(), w_scale.data_ptr(),
                                  x_scale.dim() == 0 ? x_scale.data_ptr() : nullptr,
                                  bias_ptr(bias, out_kind), out.data_ptr(), (int)B, (int)H,
                                  (int)W, (int)C, (int)N, (int)KH, (int)KW, (int)pad,
                                  (int)out_kind, (int)plan[0], (int)plan[1], (int)plan[2],
                                  (int)plan[3], (int)plan[4], (int)plan[5], (int)plan[6],
                                  (int)plan[7], stream_of(xq)),
               "avp::int8_conv_halo");
  ++g_calls[kInt8Halo];
  return out;
}

// The 1x1 routes: x int8 (0), bf16 (1) or f32 (2); a float x with x_rcp.
int in_kind_of(const at::Tensor& x, const at::Tensor& x_scale,
               const std::optional<at::Tensor>& x_rcp) {
  const at::ScalarType t = x.scalar_type();
  TORCH_CHECK(t == at::kChar || t == at::kBFloat16 || t == at::kFloat,
              "x must be int8, bf16 or f32, got ", t);
  if (t == at::kChar) return 0;
  TORCH_CHECK(x_rcp.has_value(), "a float x needs x_rcp, 1 / x_scale in float64");
  check_cuda(*x_rcp, "x_rcp", at::kDouble);
  TORCH_CHECK(x_rcp->sizes() == x_scale.sizes() && x_rcp->is_contiguous(),
              "x_rcp must have x_scale's shape ", x_scale.sizes(), ", got ", x_rcp->sizes());
  return t == at::kBFloat16 ? 1 : 2;
}

// plan: bm, bn, m_tiles, n_tiles, cs, k_per_rank
at::Tensor int8_conv_pointwise(const at::Tensor& x, const at::Tensor& weight,
                               const at::Tensor& w_scale, const at::Tensor& x_scale,
                               const std::optional<at::Tensor>& x_rcp,
                               const std::optional<at::Tensor>& bias, at::IntArrayRef plan,
                               int64_t out_kind) {
  check_nhwc(x, "x");
  check_nhwc(weight, "weight");
  TORCH_CHECK(weight.scalar_type() == at::kChar && weight.size(2) == 1 && weight.size(3) == 1,
              "weight must be int8 (N, C, 1, 1)");
  TORCH_CHECK(plan.size() == 6, "avp::int8_conv_pointwise: plan (bm, bn, m_tiles, n_tiles, "
              "cs, k_per_rank), got ", plan);
  const int64_t B = x.size(0), C = x.size(1), H = x.size(2), W = x.size(3), N = weight.size(0);
  TORCH_CHECK(weight.size(1) == C, "weight ", weight.sizes(), " does not take ", C, " channels");
  check_epilogue(x, w_scale, x_scale, bias, C, N, out_kind);
  const int in_kind = in_kind_of(x, x_scale, x_rcp);
  const c10::cuda::CUDAGuard guard(x.device());
  at::Tensor out = nhwc_empty(x, B, N, H, W, out_type(out_kind));
  check_launch(avp_int8_conv_pointwise(
                   x.data_ptr(), in_kind, x_scale.data_ptr(),
                   in_kind ? x_rcp->data_ptr() : nullptr, x_scale.dim() == 1, weight.data_ptr(),
                   w_scale.data_ptr(), bias_ptr(bias, out_kind), out.data_ptr(), (int)(B * H * W),
                   (int)C, (int)N, (int)out_kind, (int)plan[0], (int)plan[1], (int)plan[2],
                   (int)plan[3], (int)plan[4], (int)plan[5], stream_of(x)),
               "avp::int8_conv_pointwise");
  ++g_calls[kInt8Pointwise];
  return out;
}

at::Tensor int8_conv_dot(const at::Tensor& x, const at::Tensor& weight,
                         const at::Tensor& w_scale, const at::Tensor& x_scale,
                         const std::optional<at::Tensor>& x_rcp,
                         const std::optional<at::Tensor>& bias, int64_t lanes, int64_t out_kind) {
  check_nhwc(x, "x");
  check_nhwc(weight, "weight");
  TORCH_CHECK(weight.scalar_type() == at::kChar && weight.size(2) == 1 && weight.size(3) == 1,
              "weight must be int8 (N, C, 1, 1)");
  const int64_t B = x.size(0), C = x.size(1), H = x.size(2), W = x.size(3), N = weight.size(0);
  TORCH_CHECK(weight.size(1) == C, "weight ", weight.sizes(), " does not take ", C, " channels");
  check_epilogue(x, w_scale, x_scale, bias, C, N, out_kind);
  const int in_kind = in_kind_of(x, x_scale, x_rcp);
  const c10::cuda::CUDAGuard guard(x.device());
  at::Tensor out = nhwc_empty(x, B, N, H, W, out_type(out_kind));
  check_launch(avp_int8_conv_dot(x.data_ptr(), in_kind, x_scale.data_ptr(),
                                 in_kind ? x_rcp->data_ptr() : nullptr, x_scale.dim() == 1,
                                 weight.data_ptr(), w_scale.data_ptr(), bias_ptr(bias, out_kind),
                                 out.data_ptr(), (int)(B * H * W), (int)C, (int)N,
                                 (int)out_kind, (int)lanes, stream_of(x)),
               "avp::int8_conv_dot");
  ++g_calls[kInt8Dot];
  return out;
}

// The transposed conv's product: xq (B, C, h, w) int8 channels_last; weight
// int8 (C, O, kh, kw) over a (kh, kw, O, C) buffer; plan: th, tw, m_tiles,
// n_tiles, splits, per_split, blocks. -> (B, O, h kh, w kw) channels_last.
at::Tensor int8_conv_d2s(const at::Tensor& xq, const at::Tensor& weight,
                         const at::Tensor& w_scale, const at::Tensor& x_scale,
                         const std::optional<at::Tensor>& bias, at::IntArrayRef plan,
                         bool tma_store, int64_t out_kind) {
  check_nhwc(xq, "xq");
  TORCH_CHECK(xq.scalar_type() == at::kChar, "xq must be int8");
  check_cuda(weight, "weight", at::kChar);
  TORCH_CHECK(weight.dim() == 4 && weight.permute({2, 3, 1, 0}).is_contiguous(),
              "weight must be (C, O, kh, kw) over a (kh, kw, O, C) buffer, got sizes ",
              weight.sizes(), " strides ", weight.strides());
  TORCH_CHECK(plan.size() == 7, "avp::int8_conv_d2s: plan (th, tw, m_tiles, n_tiles, splits, "
              "per_split, blocks), got ", plan);
  const int64_t B = xq.size(0), C = xq.size(1), h = xq.size(2), w = xq.size(3);
  const int64_t O = weight.size(1), kh = weight.size(2), kw = weight.size(3);
  TORCH_CHECK(weight.size(0) == C, "weight ", weight.sizes(), " does not take ", C, " channels");
  TORCH_CHECK(x_scale.dim() == 0, "the int8 conv-transpose takes one scalar input scale");
  check_epilogue(xq, w_scale, x_scale, bias, C, O, out_kind);
  const int64_t splits = plan[4];
  const c10::cuda::CUDAGuard guard(xq.device());
  at::Tensor out = nhwc_empty(xq, B, O, h * kh, w * kw, out_type(out_kind));
  // split-K: each split's (M, n_tiles 128) partial sums, then one arrival
  // counter a tile
  at::Tensor ws;
  if (splits > 1)
    ws = at::empty({splits * B * h * w * plan[3] * 128 + plan[2] * plan[3]},
                   xq.options().dtype(at::kInt));
  check_launch(avp_int8_conv_d2s(xq.data_ptr(), weight.data_ptr(), w_scale.data_ptr(),
                                 x_scale.data_ptr(), bias_ptr(bias, out_kind), out.data_ptr(),
                                 splits > 1 ? ws.data_ptr() : nullptr, (int)B, (int)h, (int)w,
                                 (int)C, (int)O, (int)kh, (int)kw, (int)out_kind, (int)plan[0],
                                 (int)plan[1], (int)plan[2], (int)plan[3], (int)splits,
                                 (int)plan[5], (int)plan[6], tma_store, stream_of(xq)),
               "avp::int8_conv_d2s");
  ++g_calls[kInt8D2s];
  return out;
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
  const std::vector<at::Tag> fixed = {at::Tag::needs_fixed_stride_order};
  m.def("int8_quantize(Tensor x, Tensor x_scale) -> Tensor", fixed);
  for (const char* route : {"wgmma", "splitk", "strided"})
    m.def((std::string("int8_conv_") + route +
           "(Tensor xq, Tensor weight, Tensor w_scale, Tensor x_scale, Tensor? bias, "
           "int[] geometry, int[] plan, int out_kind) -> Tensor")
              .c_str(),
          fixed);
  m.def("int8_conv_halo(Tensor xq, Tensor weight, Tensor w_scale, Tensor x_scale, Tensor? bias, "
        "int pad, int[] plan, int out_kind) -> Tensor",
        fixed);
  m.def("int8_conv_pointwise(Tensor x, Tensor weight, Tensor w_scale, Tensor x_scale, "
        "Tensor? x_rcp, Tensor? bias, int[] plan, int out_kind) -> Tensor",
        fixed);
  m.def("int8_conv_dot(Tensor x, Tensor weight, Tensor w_scale, Tensor x_scale, Tensor? x_rcp, "
        "Tensor? bias, int lanes, int out_kind) -> Tensor",
        fixed);
  m.def("int8_conv_d2s(Tensor xq, Tensor weight, Tensor w_scale, Tensor x_scale, Tensor? bias, "
        "int[] plan, bool tma_store, int out_kind) -> Tensor",
        fixed);
}

TORCH_LIBRARY_IMPL(avp, CUDA, m) {
  m.impl("fused_preprocess", &fused_preprocess);
  m.impl("fused_letterbox", &fused_letterbox);
  m.impl("lane_filter_walk", &lane_filter_walk);
  m.impl("nms_greedy", &nms_greedy);
  m.impl("int8_quantize", &int8_quantize);
  m.impl("int8_conv_wgmma", &int8_conv_wgmma);
  m.impl("int8_conv_splitk", &int8_conv_splitk);
  m.impl("int8_conv_strided", &int8_conv_strided);
  m.impl("int8_conv_halo", &int8_conv_halo);
  m.impl("int8_conv_pointwise", &int8_conv_pointwise);
  m.impl("int8_conv_dot", &int8_conv_dot);
  m.impl("int8_conv_d2s", &int8_conv_d2s);
}
