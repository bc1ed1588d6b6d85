// visionpilot_app: the Python-free production loop of the PyTorch port.
//
// The counterpart of host/tools/visionpilot_app.cpp at the repository root
// (the JAX package's loop over a TensorFlow session). The per-frame lateral
// stack (preprocess -> EgoLanes -> temporal AutoSteer -> LaneFilter ->
// LaneTracker -> PathFinder -> steering) is ONE AOTInductor package
// (export/native_app.py); with --lon the AutoSpeed detection package
// (letterbox -> net -> decode -> NMS) runs in the same process and its
// (max_det, 7) table feeds the native longitudinal stack (avp/
// longitudinal.hpp: ObjectFinder -> RSS -> PI, the main.cpp:662-785 path).
// On the card the packages call the hand kernels as the operators avp::*
// of libavp_torch_ops.so (csrc/torch_ops.cpp), which --ops loads before the
// packages so that their calls resolve through the dispatcher.
//
//   frame source (frame_ring SHM or a .npy uint8 stack)
//     -> the lateral package (state outputs fed back as the next frame's
//        state inputs, on the device; PathFinder's draw from a generator
//        restored to the bundle's state, so the trajectory continues the
//        exporter's)
//     -> [--lon] the detection package
//        -> ObjectFinder/Kalman -> SpeedPlanner -> PIController
//     -> full VisionPilotState POD published to /visionpilot_state
//
// Usage:
//   visionpilot_app <bundle_dir> <name>
//       [--ops <libavp_torch_ops.so>]  the operator library to load first
//       [--frames <stack.npy>]     uint8 (N,H,W,C) frame stack source
//       [--ring <shm_name>]        frame_ring SHM source (live capture)
//       [--max-frames N]           stop after N frames (default: stack
//                                  length, or 0 = run forever for --ring)
//       [--golden]                 run <name>_probe_frame.npy first and
//                                  verify out_0 against
//                                  <name>_probe_scalars.npy (tol 2e-3)
//       [--lon <name2>]            also run the <name2> detection bundle
//       [--can <iface|log.asc>]    ego speed/steering from SocketCAN or a
//                                  Vector .asc replay (0xA1 speed, 0xA4
//                                  steering)
//       [--ego-speed V]            fallback ego speed m/s (default 10.0)
//       [--state-shm <seg>]        publish segment (default
//                                  /visionpilot_state)
//       [--dump <out.npy>]         write the FINAL iteration's out_0 (f32)
//
// Prints the frames' wall time per frame past the first (mean, p50, p99:
// upload, the packages and the download of their outputs) and, with --ops, each
// operator's calls in this process, and the int8 operators' calls a frame. Exit 0 on success (and golden parity,
// if requested).

#include <dlfcn.h>

#include <algorithm>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <memory>
#include <mutex>
#include <optional>
#include <string>
#include <thread>
#include <vector>

#include <ATen/ATen.h>
#include <ATen/Context.h>
#include <torch/csrc/inductor/aoti_package/model_package_loader.h>

#include "avp/can_reader.hpp"
#include "avp/frame_ring.hpp"
#include "avp/longitudinal.hpp"
#include "avp/shared_state.hpp"
#include "npy_io.hpp"

namespace {

// the operators in the order of csrc/torch_ops.cpp's counters
const char* const kOps[] = {"fused_preprocess",    "fused_letterbox",   "lane_filter_walk",
                            "nms_greedy",          "int8_quantize",     "int8_conv_wgmma",
                            "int8_conv_splitk",    "int8_conv_strided", "int8_conv_halo",
                            "int8_conv_pointwise", "int8_conv_dot",     "int8_conv_d2s"};
constexpr int kNumOps = sizeof(kOps) / sizeof(kOps[0]);

struct Manifest {
  std::string package, device = "cpu";
  int64_t frame_h = 0, frame_w = 0, frame_c = 0;
  int noise = 0, n_state = 0, n_out = 0;
};

Manifest parse_manifest(const std::string& path) {
  std::ifstream f(path);
  if (!f) {
    std::fprintf(stderr, "cannot open manifest %s\n", path.c_str());
    std::exit(2);
  }
  Manifest m;
  std::string key;
  while (f >> key) {
    if (key == "package") {
      f >> m.package;
    } else if (key == "device") {
      f >> m.device;
    } else if (key == "frame") {
      f >> m.frame_h >> m.frame_w >> m.frame_c;
    } else if (key == "noise") {
      f >> m.noise;
    } else if (key == "n_state") {
      f >> m.n_state;
    } else if (key == "n_out") {
      f >> m.n_out;
    } else {  // "out i rank dims...": the shapes come back from the package
      std::string rest;
      std::getline(f, rest);
    }
  }
  return m;
}

at::Tensor from_npy(const avp::NpyArray& a) {
  return at::from_blob((void*)a.data.data(), a.shape, at::kFloat).clone();
}

// One exported bundle: the compiled package, its carried state and, when
// the state held one, its generator. run() feeds the frame (and the state),
// returns the out_j tensors and retires state_out_i into the next
// iteration's inputs.
struct Program {
  Manifest man;
  at::Device device{at::kCPU};
  std::unique_ptr<torch::inductor::AOTIModelPackageLoader> loader;
  std::vector<at::Tensor> state;
  std::optional<at::Generator> gen;

  void load(const std::string& dir, const std::string& name) {
    man = parse_manifest(dir + "/" + name + "_manifest.txt");
    device = man.device == "cuda" ? at::Device(at::kCUDA, 0) : at::Device(at::kCPU);
    loader = std::make_unique<torch::inductor::AOTIModelPackageLoader>(dir + "/" + man.package);
    for (int i = 0; i < man.n_state; ++i)
      state.push_back(from_npy(avp::read_npy_f32(dir + "/" + name + "_state_" +
                                                 std::to_string(i) + ".npy"))
                          .to(device));
    if (man.noise > 0) {
      const avp::NpyArrayU8 bytes = avp::read_npy_u8(dir + "/" + name + "_rng.npy");
      gen = at::globalContext().defaultGenerator(device).clone();
      gen->set_state(at::from_blob((void*)bytes.data.data(), bytes.shape, at::kByte).clone());
    }
  }

  std::vector<at::Tensor> run(const uint8_t* fdata) {
    std::vector<at::Tensor> in{
        at::from_blob((void*)fdata, {man.frame_h, man.frame_w, man.frame_c}, at::kByte)
            .to(device)};
    if (gen) in.push_back(at::rand({man.noise}, *gen, at::TensorOptions().device(device)));
    in.insert(in.end(), state.begin(), state.end());
    std::vector<at::Tensor> out = loader->run(in);
    if ((int)out.size() != man.n_out + man.n_state) {
      std::fprintf(stderr, "%s returned %zu tensors, the manifest says %d\n",
                   man.package.c_str(), out.size(), man.n_out + man.n_state);
      std::exit(2);
    }
    // an output may be a view off the 16 bytes the package was compiled to
    // take its inputs at; a copy of its own spares the package that copy
    // (and its warning) on the next frame
    for (int i = 0; i < man.n_state; ++i) {
      const at::Tensor& t = out[man.n_out + i];
      state[i] = reinterpret_cast<uintptr_t>(t.data_ptr()) % 16 ? t.clone() : t;
    }
    out.resize(man.n_out);
    for (at::Tensor& t : out) t = t.to(at::kCPU).to(at::kFloat).contiguous();
    return out;
  }
};

double ms_since(std::chrono::steady_clock::time_point t0);

// The detection program's own thread, kept for the whole run: cuDNN's and
// cuBLAS's per-thread state (handles, the convolutions' plan caches) would
// be built anew on a fresh thread every frame (a thread a frame took
// ~270 ms a frame for AutoSpeed "n", against ~4 ms on a kept thread).
class Worker {
 public:
  explicit Worker(Program& program) : program_(program), thread_([this] { loop(); }) {}
  ~Worker() {
    {
      std::lock_guard<std::mutex> lock(mutex_);
      stop_ = true;
    }
    cv_.notify_all();
    thread_.join();
  }
  void submit(const uint8_t* frame) {
    {
      std::lock_guard<std::mutex> lock(mutex_);
      frame_ = frame;
      done_ = false;
    }
    cv_.notify_all();
  }
  // -> the outputs of the frame submitted last, and the milliseconds it took
  std::vector<at::Tensor> wait(double* ms) {
    std::unique_lock<std::mutex> lock(mutex_);
    cv_.wait(lock, [this] { return done_; });
    *ms = ms_;
    return std::move(out_);
  }

 private:
  void loop() {
    std::unique_lock<std::mutex> lock(mutex_);
    for (;;) {
      cv_.wait(lock, [this] { return stop_ || frame_ != nullptr; });
      if (stop_) return;
      const uint8_t* frame = frame_;
      frame_ = nullptr;
      lock.unlock();
      const auto t0 = std::chrono::steady_clock::now();
      std::vector<at::Tensor> out = program_.run(frame);
      const double ms = ms_since(t0);
      lock.lock();
      out_ = std::move(out);
      ms_ = ms;
      done_ = true;
      cv_.notify_all();
    }
  }

  Program& program_;
  std::mutex mutex_;
  std::condition_variable cv_;
  const uint8_t* frame_ = nullptr;
  std::vector<at::Tensor> out_;
  double ms_ = 0.0;
  bool done_ = true, stop_ = false;
  std::thread thread_;  // last: it starts once the members above exist
};

double ms_since(std::chrono::steady_clock::time_point t0) {
  return std::chrono::duration<double, std::milli>(std::chrono::steady_clock::now() - t0).count();
}

double percentile(std::vector<double> v, double q) {
  if (v.empty()) return 0.0;
  std::sort(v.begin(), v.end());
  const double pos = q * (v.size() - 1);
  const size_t lo = (size_t)pos;
  const size_t hi = std::min(lo + 1, v.size() - 1);
  return v[lo] + (pos - lo) * (v[hi] - v[lo]);
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 3) {
    std::fprintf(stderr,
                 "usage: %s <bundle_dir> <name> [--ops <lib.so>] [--frames <stack.npy>] "
                 "[--ring <shm>] [--max-frames N] [--golden] [--lon <name2>] "
                 "[--can <src>] [--ego-speed V] [--state-shm <seg>] [--dump <out.npy>]\n",
                 argv[0]);
    return 2;
  }
  const std::string dir = argv[1];
  const std::string name = argv[2];
  std::string frames_npy, ring_name, dump_npy, lon_name, can_src, ops_lib;
  std::string state_shm = "/visionpilot_state";
  long max_frames = -1;
  bool golden = false;
  double ego_speed = 10.0;  // ego_speed_default_ms (runtime/config.py)
  for (int i = 3; i < argc; ++i) {
    if (!std::strcmp(argv[i], "--frames") && i + 1 < argc)
      frames_npy = argv[++i];
    else if (!std::strcmp(argv[i], "--ring") && i + 1 < argc)
      ring_name = argv[++i];
    else if (!std::strcmp(argv[i], "--max-frames") && i + 1 < argc)
      max_frames = std::strtol(argv[++i], nullptr, 10);
    else if (!std::strcmp(argv[i], "--golden"))
      golden = true;
    else if (!std::strcmp(argv[i], "--lon") && i + 1 < argc)
      lon_name = argv[++i];
    else if (!std::strcmp(argv[i], "--can") && i + 1 < argc)
      can_src = argv[++i];
    else if (!std::strcmp(argv[i], "--ego-speed") && i + 1 < argc)
      ego_speed = std::atof(argv[++i]);
    else if (!std::strcmp(argv[i], "--state-shm") && i + 1 < argc)
      state_shm = argv[++i];
    else if (!std::strcmp(argv[i], "--dump") && i + 1 < argc)
      dump_npy = argv[++i];
    else if (!std::strcmp(argv[i], "--ops") && i + 1 < argc)
      ops_lib = argv[++i];
  }

  // the operator library first: a package's avp::* calls resolve through
  // the dispatcher, where loading the library registers them
  long long (*op_calls)(int) = nullptr;
  if (!ops_lib.empty()) {
    void* handle = dlopen(ops_lib.c_str(), RTLD_NOW | RTLD_GLOBAL);
    if (handle == nullptr) {
      std::fprintf(stderr, "cannot load %s: %s\n", ops_lib.c_str(), dlerror());
      return 2;
    }
    op_calls = (long long (*)(int))dlsym(handle, "avp_torch_op_calls");
    if (op_calls == nullptr) {
      std::fprintf(stderr, "%s has no avp_torch_op_calls\n", ops_lib.c_str());
      return 2;
    }
  }

  // full f32 in the packages' convolutions and matrix products (no TF32),
  // as export/native_app.py's golden probe and replay run them: the
  // lateral fits turn the last bits of the lane logits into steering
  at::globalContext().setAllowTF32CuDNN(false);
  at::globalContext().setAllowTF32CuBLAS(false);

  Program lat;
  lat.load(dir, name);
  const Manifest& man = lat.man;
  const int64_t frame_bytes = man.frame_h * man.frame_w * man.frame_c;
  std::fprintf(stderr,
               "visionpilot_app: %s on %s frame=%lldx%lldx%lld noise=%d n_state=%d "
               "n_out=%d%s\n",
               man.package.c_str(), man.device.c_str(), (long long)man.frame_h,
               (long long)man.frame_w, (long long)man.frame_c, man.noise, man.n_state,
               man.n_out, lon_name.empty() ? "" : " +longitudinal");

  Program lon;
  const bool with_lon = !lon_name.empty();
  if (with_lon) {
    lon.load(dir, lon_name);
    // both programs read the SAME frame buffer: a dim mismatch would be an
    // out-of-bounds read, not a smaller inference — refuse early
    if (lon.man.frame_h != man.frame_h || lon.man.frame_w != man.frame_w ||
        lon.man.frame_c != man.frame_c) {
      std::fprintf(stderr, "--lon bundle frame dims do not match the lateral bundle's\n");
      return 2;
    }
  }

  // native longitudinal stack (reference main.cpp:662-785); flat-ground
  // homography placeholder, as the root loop's
  const double hom[9] = {0.02, 0.0, -12.8, 0.0, -0.09, 72.0, 0.0, 0.001, 0.28};
  avp::lon::ObjectFinder finder(hom, (int)man.frame_w, (int)man.frame_h);
  avp::lon::SpeedPlanner planner;
  avp::lon::PIController pid(0.5, 0.1, 0.05);  // LongitudinalConfig gains
  std::unique_ptr<avp::can::CanReader> can;
  if (!can_src.empty()) can = std::make_unique<avp::can::CanReader>(can_src);

  // --- frame source -------------------------------------------------------
  avp::NpyArrayU8 stack;
  std::unique_ptr<avp::host::FrameRing> ring;
  long n_stack = 0;
  if (!frames_npy.empty()) {
    stack = avp::read_npy_u8(frames_npy);
    if ((int)stack.shape.size() != 4 || stack.shape[1] != man.frame_h ||
        stack.shape[2] != man.frame_w || stack.shape[3] != man.frame_c) {
      std::fprintf(stderr, "frame stack shape mismatch vs manifest\n");
      return 2;
    }
    n_stack = stack.shape[0];
    if (max_frames < 0) max_frames = n_stack;
  } else if (!ring_name.empty()) {
    ring = std::make_unique<avp::host::FrameRing>(ring_name.c_str(), /*owner=*/false);
    if (!ring->ok()) {
      std::fprintf(stderr, "cannot attach frame ring %s\n", ring_name.c_str());
      return 2;
    }
  } else if (!golden) {
    std::fprintf(stderr, "need --frames, --ring or --golden\n");
    return 2;
  }

  avp::NpyArrayU8 probe;
  avp::NpyArray probe_scalars;
  if (golden) {
    probe = avp::read_npy_u8(dir + "/" + name + "_probe_frame.npy");
    probe_scalars = avp::read_npy_f32(dir + "/" + name + "_probe_scalars.npy");
  }

  avp::host::SharedState shm(state_shm.c_str(), /*owner=*/true);
  if (!shm.ok()) {
    std::fprintf(stderr, "cannot create %s\n", state_shm.c_str());
    return 2;
  }

  std::vector<uint8_t> ring_buf(frame_bytes);
  avp::host::FrameHeader fh{};
  uint64_t last_seen = 0;
  bool golden_ok = true;
  long done = 0;
  std::vector<double> frame_ms, lat_times, lon_times;
  std::unique_ptr<Worker> lon_worker;
  if (with_lon) lon_worker = std::make_unique<Worker>(lon);
  const auto wall0 = std::chrono::steady_clock::now();

  for (long it = 0;; ++it) {
    // the golden probe runs as iteration 0 from the exporter's state,
    // reproducing the exporter's probe run
    uint8_t* fdata = nullptr;
    uint64_t frame_number = (uint64_t)it + 1;
    if (golden && it == 0) {
      fdata = probe.data.data();
    } else if (n_stack > 0) {
      const long idx = (golden ? it - 1 : it) % n_stack;  // the probe was it == 0
      fdata = stack.data.data() + idx * frame_bytes;
    } else if (ring) {
      while (!ring->read_latest(ring_buf.data(), (uint32_t)frame_bytes, &fh, last_seen)) {
        // producer-paced: spin-wait for a fresh frame
      }
      last_seen = fh.frame_number;
      frame_number = fh.frame_number;
      fdata = ring_buf.data();
    } else {
      break;  // --golden only: single probe iteration
    }

    const auto t0 = std::chrono::steady_clock::now();
    // the two programs are independent consumers of the same frame: the
    // detector runs on its own thread beside the lateral program
    std::vector<at::Tensor> lon_out;
    double lon_ms = 0.0;
    if (lon_worker) lon_worker->submit(fdata);
    const std::vector<at::Tensor> lat_out = lat.run(fdata);
    const double lat_ms = ms_since(t0);
    if (lon_worker) lon_out = lon_worker->wait(&lon_ms);
    if (it > 0) {  // iteration 0 is the packages' first run
      frame_ms.push_back(ms_since(t0));
      lat_times.push_back(lat_ms);
      lon_times.push_back(lon_ms);
    }

    // --- publish the full state POD ---------------------------------------
    avp::host::VisionPilotState st{};
    st.frame_number = frame_number;

    // SCALAR_FIELDS layout (runtime/pipeline.py): out_0 = [steering_filtered,
    // steering_raw, autosteer_deg, cte, yaw_error, lane_width, fused_valid,
    // path_valid].
    const float* scal = lat_out[0].data_ptr<float>();
    const int n_scal = (int)lat_out[0].numel();
    if (n_scal >= 8) {
      st.steering_pid_deg = scal[0];
      st.steering_pid_raw_deg = scal[1];
      st.steering_autosteer_deg = scal[2];
      st.cte_m = scal[3];
      st.yaw_error_rad = scal[4];
      st.autosteer_valid = scal[6] > 0.5f;
      st.path_valid = scal[7] > 0.5f;
      st.lane_departure_warning = st.path_valid && std::fabs(scal[3]) > 0.9;
    }

    // CAN poll once per captured frame (main.cpp:427-432); graceful
    // degradation: invalid CAN keeps the fallback ego speed.
    double ego_now = ego_speed;
    if (can) {
      const double now_can =
          std::chrono::duration<double>(std::chrono::steady_clock::now() - wall0).count();
      const auto& cs = can->update(now_can);
      st.can_valid = cs.valid;
      st.ego_steering_angle_deg = std::isnan(cs.steering_angle_deg) ? 0.0 : cs.steering_angle_deg;
      if (cs.valid) ego_now = cs.speed_ms;
      st.ego_speed_ms = ego_now;
    }

    if (with_lon) {
      // detection table (max_det, 7): x1,y1,x2,y2,score,class,valid
      const float* tab = lon_out[0].data_ptr<float>();
      const int64_t rows = lon_out[0].size(0);
      std::vector<avp::lon::Detection> dets;
      for (int64_t r = 0; r < rows; ++r) {
        const float* row = tab + r * 7;
        if (row[6] > 0.5f) dets.push_back({row[0], row[1], row[2], row[3], row[4], (int)row[5]});
      }
      const double now =
          std::chrono::duration<double>(std::chrono::steady_clock::now() - wall0).count();
      const auto trk = finder.update_and_get_cipo(dets, now, fdata);

      // wiring order as runtime/pipeline.py's _harvest
      planner.set_ego_speed(ego_now);
      planner.set_is_cipo_present(trk.cipo.exists);
      if (trk.cipo.exists) planner.set_cipo_state(trk.cipo.velocity_ms, trk.cipo.distance_m);
      const double set_speed = planner.calc_ideal_driving_speed();
      if (trk.cut_in_detected || trk.kalman_reset) pid.reset();
      const double effort = pid.compute_effort(ego_now, set_speed);

      st.cipo_exists = trk.cipo.exists;
      st.cipo_track_id = trk.cipo.track_id;
      st.cipo_class_id = trk.cipo.class_id;
      st.cipo_distance_m = trk.cipo.distance_m;
      st.cipo_velocity_ms = trk.cipo.velocity_ms;
      st.cut_in_detected = trk.cut_in_detected;
      st.kalman_reset = trk.kalman_reset;
      st.ideal_speed_ms = set_speed;
      st.safe_distance_m = planner.calc_safe_rss_distance();
      st.fcw_active = planner.fcw();
      st.aeb_active = planner.aeb();
      st.control_effort_ms2 = effort;
      st.ego_speed_ms = ego_now;
    }
    shm.publish(st);

    if (!dump_npy.empty()) {
      avp::NpyArray a;
      a.shape = {n_scal};
      a.data.assign(scal, scal + n_scal);
      avp::write_npy_f32(dump_npy, a);  // last write wins: the final out_0
    }

    if (golden && it == 0) {
      float max_diff = 0.f;
      for (int64_t k = 0; k < probe_scalars.size() && k < n_scal; ++k)
        max_diff = std::fmax(max_diff, std::fabs(scal[k] - probe_scalars.data[k]));
      std::fprintf(stderr, "golden probe: max|diff|=%g (tol 2e-3)\n", max_diff);
      golden_ok = max_diff <= 2e-3f;
    }
    ++done;
    if (max_frames >= 0 && done >= max_frames + (golden ? 1 : 0)) break;
    if (max_frames < 0 && !ring && !(golden && it == 0) && n_stack == 0) break;
  }

  double total = 0.0;
  for (double t : frame_ms) total += t;
  const double timed = (double)std::max<size_t>(frame_ms.size(), 1);
  std::printf("visionpilot_app: %ld frames; past the first, %.3f ms/frame (%.1f FPS), "
              "p50 %.3f ms, p99 %.3f ms\n",
              done, total / timed, 1e3 * timed / std::max(total, 1e-9),
              percentile(frame_ms, 0.5), percentile(frame_ms, 0.99));
  std::printf("stages, p50: lateral package %.3f ms, longitudinal package %.3f ms (each with "
              "its frame's upload and its outputs' download)\n",
              percentile(lat_times, 0.5), percentile(lon_times, 0.5));
  if (op_calls != nullptr) {
    std::printf("op calls:");
    for (int i = 0; i < kNumOps; ++i) std::printf(" %s %lld", kOps[i], op_calls(i));
    std::printf("\n");
    // the int8 operators (an int8 package's quantize and conv routes) a frame
    std::printf("int8 op calls a frame:");
    for (int i = 4; i < kNumOps; ++i)
      std::printf(" %s %.3f", kOps[i], (double)op_calls(i) / (double)std::max<long>(done, 1));
    std::printf("\n");
  }
  std::fflush(stdout);
  return golden_ok ? 0 : 1;
}
