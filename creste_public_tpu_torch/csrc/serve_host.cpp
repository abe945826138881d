// creste_serve_host: a libtorch host, with no Python in it, that serves the
// deployment graph from the port's native artifact.
//
// The counterpart of native/creste_serve.cpp (the JAX package's PJRT host),
// which stands in for the reference's deployment story: a trace run by a
// C++ ROS node. runtime/export.py::export_native_artifacts(package=True)
// (compile --native-dir D --native-package) writes into DIR an AOTInductor
// package of the exported graph and a manifest:
//   format torch_export
//   input  <name> <dtype> <d0,d1,...>
//   output <name> <dtype> <d0,d1,...>
//   package <file> <cuda|cpu>
// This host loads the package (torch::inductor::AOTIModelPackageLoader) and
// serves it. The package calls the reward head as the operator
// creste::msfcn_head and the splat's scatter as creste::splat_sums, which
// the linked library of csrc/msfcn_head_op.cpp and csrc/splat_op.cpp
// registers: on the card the four launches of csrc/msfcn_chain.cu and one
// call of csrc/splat.cu per frame.
//
// Usage:
//   creste_serve_host --artifact DIR [--device cuda|cpu] [--iters 30]
//       [--warmup 3] [--distinct 8] [--pipeline 2]
//       [--in rgbd=frame.bin,p2p=p2p.bin] [--dump DIR] [--fetch k1,k2]
//       [--tf32]
//
// --device defaults to cuda; without a GPU the host exits 2 unless given
// --device cpu (and a package compiled for the CPU). --in feeds raw
// row-major tensors (the manifest's dtype and dims, byte counts checked) in
// place of the synthetic fill; --dump writes each output's raw bytes of the
// frame of those inputs to DIR/<name>.bin.
//
// Timing: after --warmup frames, --iters frames each on a fresh
// device-resident input: the first input's channels but the last (RGB, the
// depth kept) re-drawn uniform in [0, 1), cycling through --distinct such
// frames made on the device before the timing, as runtime/benchmark.frame_times_ms does; CUDA
// events around each frame on the card, the host clock on the CPU.
// --pipeline N (default 2; 0 disables) then streams --iters frames from
// pinned host memory, the outputs named by --fetch (default: every output)
// read back to pinned host memory: once
// one frame at a time (the sequential baseline, with its H2D, execute and
// D2H legs) and, for N > 1, with frame i+1's H2D staged on a copy stream
// while frame i runs and its outputs drain on a third stream, at most N
// frames in flight.
//
// TF32: libtorch's cuDNN convolutions default to TF32; the port's numbers
// are taken with TF32 off, so the host turns it off for cuDNN and cuBLAS
// and sets the f32 matmul precision to highest, unless given --tf32.
//
// Inputs and outputs follow the manifest's dtypes (an f32 or a bf16
// graph's): --in files, the synthetic fill, the read-back buffers and the
// dumps are laid out by them, and an output whose dtype or dims differ from
// the manifest's is an error (exit 1).
//
// Prints one JSON line: per_frame_ms, hz, load_s, iters, distinct, the
// seq_* and pipeline_* fields when streaming, outputs (name, dims,
// checksum), msfcn_head_launches and msfcn_head_calls, splat_sums_launches
// and splat_sums_calls with frames_run, and the registered operators'
// schemas.
#include <ATen/ATen.h>
#include <ATen/CPUGeneratorImpl.h>
#include <ATen/core/dispatch/Dispatcher.h>
#include <torch/csrc/inductor/aoti_package/model_package_loader.h>
#include <torch/cuda.h>

#include <algorithm>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <fstream>
#include <sstream>
#include <string>
#include <vector>

#ifdef CRESTE_WITH_CUDA
#include <ATen/cuda/CUDAContext.h>
#include <ATen/cuda/CUDAEvent.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#endif

extern "C" int64_t creste_msfcn_head_launches();
extern "C" int64_t creste_msfcn_head_calls();
extern "C" int64_t creste_splat_sums_launches();
extern "C" int64_t creste_splat_sums_calls();

namespace {

struct TensorSpec {
  std::string name, dtype;
  std::vector<int64_t> dims;
};

[[noreturn]] void usage_error(const std::string& msg) {
  fprintf(stderr, "%s\n", msg.c_str());
  exit(2);
}

at::ScalarType scalar_type(const std::string& token) {
  if (token == "f32") return at::kFloat;
  if (token == "bf16") return at::kBFloat16;
  if (token == "f16") return at::kHalf;
  if (token == "s32") return at::kInt;
  if (token == "s64") return at::kLong;
  if (token == "u8") return at::kByte;
  if (token == "pred") return at::kBool;
  usage_error("unsupported dtype " + token);
}

std::vector<int64_t> parse_dims(const std::string& s) {
  std::vector<int64_t> dims;
  std::stringstream ss(s);
  std::string d;
  while (std::getline(ss, d, ',')) dims.push_back(std::stoll(d));
  return dims;
}

// The output names of the package in its flat order: the key list of the
// dict in its call spec's output tree ("context": "[\"a\", \"b\"]").
std::vector<std::string> output_names(const std::string& out_spec) {
  std::vector<std::string> names;
  const std::string key = "\"context\": \"[";
  size_t p = out_spec.find(key);
  if (p == std::string::npos) return names;
  p += key.size();
  const size_t end = out_spec.find(']', p);
  while (true) {
    const size_t a = out_spec.find("\\\"", p);
    if (a == std::string::npos || a > end) break;
    const size_t b = out_spec.find("\\\"", a + 2);
    names.push_back(out_spec.substr(a + 2, b - a - 2));
    p = b + 2;
  }
  return names;
}

// Deterministic xorshift fill, uniform in [0, 1) for a floating dtype (as
// the JAX host's synthetic inputs; drawn in f32, then cast), random bytes
// for any other.
void fill(at::Tensor& t, uint64_t seed) {
  uint64_t s = seed * 2654435761u + 1;
  auto next = [&s]() {
    s ^= s << 13;
    s ^= s >> 7;
    s ^= s << 17;
    return s;
  };
  if (at::isFloatingType(t.scalar_type())) {
    at::Tensor f = at::empty(t.sizes(), t.options().dtype(at::kFloat));
    float* p = f.data_ptr<float>();
    for (int64_t i = 0; i < f.numel(); ++i)
      p[i] = (float)((next() >> 40) & 0xffffff) / (float)0x1000000;
    t.copy_(f);
  } else {
    uint8_t* p = static_cast<uint8_t*>(t.data_ptr());
    for (int64_t i = 0; i < t.nbytes(); ++i) p[i] = (uint8_t)(next() >> 56);
  }
}

double seconds_since(std::chrono::steady_clock::time_point t0) {
  return std::chrono::duration<double>(std::chrono::steady_clock::now() - t0)
      .count();
}

std::string json_escape(const std::string& s) {
  std::string out;
  for (char c : s) {
    if (c == '"' || c == '\\') out += '\\';
    out += c;
  }
  return out;
}

}  // namespace

int main(int argc, char** argv) {
  std::string artifact, device_name = "cuda", in_spec, dump_dir, fetch_spec;
  int iters = 30, warmup = 3, distinct = 8, pipeline = 2;
  bool tf32 = false;
  for (int i = 1; i < argc; ++i) {
    const std::string a = argv[i];
    const bool has = i + 1 < argc;
    if (a == "--artifact" && has) artifact = argv[++i];
    else if (a == "--device" && has) device_name = argv[++i];
    else if (a == "--iters" && has) iters = atoi(argv[++i]);
    else if (a == "--warmup" && has) warmup = atoi(argv[++i]);
    else if (a == "--distinct" && has) distinct = atoi(argv[++i]);
    else if (a == "--pipeline" && has) pipeline = atoi(argv[++i]);
    else if (a == "--in" && has) in_spec = argv[++i];
    else if (a == "--dump" && has) dump_dir = argv[++i];
    else if (a == "--fetch" && has) fetch_spec = argv[++i];
    else if (a == "--tf32") tf32 = true;
    else
      usage_error(
          "usage: creste_serve_host --artifact DIR [--device cuda|cpu] "
          "[--iters N] [--warmup N] [--distinct N] [--pipeline N] "
          "[--in name=file,...] [--dump DIR] [--fetch name,...] [--tf32]");
  }
  if (artifact.empty()) usage_error("--artifact DIR is required");
  if (device_name != "cuda" && device_name != "cpu")
    usage_error("--device must be cuda or cpu, got " + device_name);
  const bool cuda = device_name == "cuda";
  if (cuda && !torch::cuda::is_available())
    usage_error("no CUDA device: the host serves on the card unless given "
                "--device cpu");
#ifndef CRESTE_WITH_CUDA
  if (cuda) usage_error("this host was built without CUDA: --device cpu");
#endif
  iters = std::max(iters, 1);
  distinct = std::max(distinct, 1);

  // ---- manifest ----
  std::ifstream mf(artifact + "/manifest.txt");
  if (!mf) usage_error("cannot read " + artifact + "/manifest.txt");
  std::vector<TensorSpec> inputs, outputs;
  std::string package, package_device, line;
  while (std::getline(mf, line)) {
    std::stringstream ss(line);
    std::string kind, name, dtype, dims;
    ss >> kind >> name >> dtype >> dims;
    if (kind == "input" || kind == "output")
      (kind == "input" ? inputs : outputs)
          .push_back({name, dtype, parse_dims(dims)});
    else if (kind == "package") {
      package = name;
      package_device = dtype;
    }
  }
  if (package.empty())
    usage_error("the manifest names no package: write it with compile "
                "--native-dir D --native-package");
  if (package_device != device_name)
    usage_error("the package was compiled for " + package_device +
                ", not for --device " + device_name);

  if (cuda && !tf32) {
    at::globalContext().setAllowTF32CuDNN(false);
    at::globalContext().setAllowTF32CuBLAS(false);
    at::globalContext().setFloat32MatmulPrecision("highest");
  }
  const auto schema_of = [](const char* name) {
    const auto op = c10::Dispatcher::singleton().findSchema({name, ""});
    if (!op) usage_error(std::string(name) + " is not registered");
    return toString(op->schema());
  };
  const std::string schema = schema_of("creste::msfcn_head");
  const std::string splat_schema = schema_of("creste::splat_sums");

  try {
    const at::Device device = cuda ? at::Device(at::kCUDA, 0)
                                   : at::Device(at::kCPU);
    auto t_load = std::chrono::steady_clock::now();
    torch::inductor::AOTIModelPackageLoader loader(
        artifact + "/" + package, "model", false, 1,
        cuda ? (c10::DeviceIndex)0 : (c10::DeviceIndex)-1);
    const double load_s = seconds_since(t_load);
    fprintf(stderr, "loaded %s in %.3f s\n", package.c_str(), load_s);

    // the package's outputs by name, each against the manifest
    const std::vector<std::string> spec = loader.get_call_spec();
    const std::vector<std::string> names =
        output_names(spec.size() > 1 ? spec[1] : "");
    if (names.size() != outputs.size())
      usage_error("the package returns " + std::to_string(names.size()) +
                  " outputs, the manifest lists " +
                  std::to_string(outputs.size()));
    std::vector<TensorSpec> out_specs;
    for (const std::string& n : names) {
      auto it = std::find_if(outputs.begin(), outputs.end(),
                             [&](const TensorSpec& t) { return t.name == n; });
      if (it == outputs.end())
        usage_error("the package's output " + n + " is not in the manifest");
      out_specs.push_back(*it);
    }

    // the outputs each streamed frame reads back
    std::vector<size_t> fetch;
    std::stringstream fetch_items(fetch_spec);
    for (std::string n; std::getline(fetch_items, n, ',');) {
      size_t o = 0;
      while (o < out_specs.size() && out_specs[o].name != n) ++o;
      if (o == out_specs.size()) usage_error("--fetch: no output named " + n);
      fetch.push_back(o);
    }
    if (fetch.empty())
      for (size_t o = 0; o < out_specs.size(); ++o) fetch.push_back(o);

    // ---- set 0: --in files or the synthetic fill, on the host ----
    std::vector<at::Tensor> host_in;
    for (size_t k = 0; k < inputs.size(); ++k) {
      host_in.push_back(at::empty(inputs[k].dims,
                                  at::TensorOptions().dtype(
                                      scalar_type(inputs[k].dtype))));
      fill(host_in.back(), k + 1);
    }
    std::stringstream items(in_spec);
    std::string item;
    while (std::getline(items, item, ',')) {
      const size_t eq = item.find('=');
      if (eq == std::string::npos)
        usage_error("--in expects name=file, got " + item);
      const std::string name = item.substr(0, eq), path = item.substr(eq + 1);
      size_t k = 0;
      while (k < inputs.size() && inputs[k].name != name) ++k;
      if (k == inputs.size())
        usage_error("--in: no input named " + name + " in the manifest");
      std::ifstream f(path, std::ios::binary | std::ios::ate);
      if (!f) usage_error("cannot read " + path);
      const size_t size = (size_t)f.tellg();
      if (size != (size_t)host_in[k].nbytes())
        usage_error(path + ": " + std::to_string(size) +
                    " bytes, the manifest expects " +
                    std::to_string(host_in[k].nbytes()));
      f.seekg(0);
      f.read(static_cast<char*>(host_in[k].data_ptr()), size);
    }
    std::vector<at::Tensor> set0;
    for (const at::Tensor& t : host_in) set0.push_back(t.to(device));

    // the fresh frames: set 0 with the first input's channels but the last
    // re-drawn (seeded), each made once and kept on the device
    std::vector<std::vector<at::Tensor>> fresh;
    at::Generator gen = at::make_generator<at::CPUGeneratorImpl>(0);
    for (int s = 0; s < distinct; ++s) {
      std::vector<at::Tensor> set;
      for (const at::Tensor& t : host_in) set.push_back(t.clone());
      const int64_t c = set[0].size(-1);
      at::Tensor rgb = c > 1 ? set[0].narrow(-1, 0, c - 1) : set[0];
      rgb.copy_(at::rand(rgb.sizes(), gen, rgb.options()));
      for (at::Tensor& t : set) t = t.to(device);
      fresh.push_back(set);
    }

    int64_t frames_run = 0;
#ifdef CRESTE_WITH_CUDA
    c10::cuda::CUDAStream compute = cuda
        ? c10::cuda::getStreamFromPool(false, 0)
        : c10::cuda::getDefaultCUDAStream(0);
#endif
    // one frame on the compute stream (the current stream while it runs)
    auto run = [&](const std::vector<at::Tensor>& in) {
      ++frames_run;
#ifdef CRESTE_WITH_CUDA
      if (cuda) {
        const c10::cuda::CUDAStreamGuard guard(compute);
        return loader.run(in, compute.stream());
      }
#endif
      return loader.run(in);
    };
    auto sync = [&]() {
#ifdef CRESTE_WITH_CUDA
      if (cuda) compute.synchronize();
#endif
    };

    // ---- warm-up and the timed frames on device-resident inputs ----
    for (int i = 0; i < warmup; ++i) run(set0);
    sync();
    std::vector<double> times;
#ifdef CRESTE_WITH_CUDA
    if (cuda) {
      std::vector<std::pair<at::cuda::CUDAEvent, at::cuda::CUDAEvent>> ev;
      for (int i = 0; i < iters; ++i)
        ev.emplace_back(at::cuda::CUDAEvent(cudaEventDefault),
                        at::cuda::CUDAEvent(cudaEventDefault));
      for (int i = 0; i < iters; ++i) {
        ev[i].first.record(compute);
        run(fresh[i % distinct]);
        ev[i].second.record(compute);
      }
      sync();
      for (auto& e : ev) times.push_back(e.first.elapsed_time(e.second));
    }
#endif
    if (!cuda) {
      for (int i = 0; i < iters; ++i) {
        auto t0 = std::chrono::steady_clock::now();
        run(fresh[i % distinct]);
        times.push_back(seconds_since(t0) * 1e3);
      }
    }
    double per_frame_ms = 0.0;
    for (double t : times) per_frame_ms += t;
    per_frame_ms /= times.size();
    std::vector<double> sorted_times = times;
    std::sort(sorted_times.begin(), sorted_times.end());
    const double p50_ms = sorted_times[sorted_times.size() / 2];
    fprintf(stderr, "%d frames on device-resident inputs: %.3f ms/frame\n",
            iters, per_frame_ms);

    // ---- streaming from pinned host memory ----
    std::vector<std::vector<at::Tensor>> host_frames;
    for (const auto& set : fresh) {
      std::vector<at::Tensor> h;
      for (const at::Tensor& t : set)
        h.push_back(cuda ? t.to(at::kCPU).pin_memory() : t.to(at::kCPU));
      host_frames.push_back(h);
    }
    struct Legs {
      double per_frame_ms = 0, h2d_ms = 0, exec_ms = 0, d2h_ms = 0;
    };
    // `depth` frames in flight; depth 1 is the sequential baseline, whose
    // H2D, execute and D2H legs are timed
    auto stream_frames = [&](int depth) {
      Legs legs;
      std::vector<std::vector<at::Tensor>> dev_in(depth), host_out(depth);
      for (int s = 0; s < depth; ++s) {
        for (const at::Tensor& t : set0) dev_in[s].push_back(at::empty_like(t));
        for (size_t o : fetch)
          host_out[s].push_back(at::empty(
              out_specs[o].dims,
              at::TensorOptions().dtype(scalar_type(out_specs[o].dtype))
                  .pinned_memory(cuda)));
      }
      auto t0 = std::chrono::steady_clock::now();
#ifdef CRESTE_WITH_CUDA
      if (cuda) {
        c10::cuda::CUDAStream h2d = c10::cuda::getStreamFromPool(false, 0);
        c10::cuda::CUDAStream d2h = c10::cuda::getStreamFromPool(false, 0);
        std::vector<at::cuda::CUDAEvent> begun, staged, computed, drained;
        for (int s = 0; s < depth; ++s)
          for (auto* v : {&begun, &staged, &computed, &drained})
            v->emplace_back(cudaEventDefault);
        auto add_legs = [&](int s) {
          legs.h2d_ms += begun[s].elapsed_time(staged[s]);
          legs.exec_ms += staged[s].elapsed_time(computed[s]);
          legs.d2h_ms += computed[s].elapsed_time(drained[s]);
        };
        for (int i = 0; i < iters; ++i) {
          const int s = i % depth;
          if (i >= depth) {
            drained[s].synchronize();  // frame i - depth is out: s is free
            if (depth == 1) add_legs(s);
          }
          {
            const c10::cuda::CUDAStreamGuard guard(h2d);
            begun[s].record(h2d);
            for (size_t k = 0; k < dev_in[s].size(); ++k)
              dev_in[s][k].copy_(host_frames[i % distinct][k], true);
            staged[s].record(h2d);
          }
          staged[s].block(compute);
          std::vector<at::Tensor> outs = run(dev_in[s]);
          computed[s].record(compute);
          computed[s].block(d2h);
          const c10::cuda::CUDAStreamGuard guard(d2h);
          for (size_t f = 0; f < fetch.size(); ++f) {
            outs[fetch[f]].record_stream(d2h);
            host_out[s][f].copy_(outs[fetch[f]], true);
          }
          drained[s].record(d2h);
        }
        for (int s = 0; s < depth; ++s) drained[s].synchronize();
        legs.per_frame_ms = seconds_since(t0) * 1e3 / iters;
        if (depth == 1) add_legs(0);
      } else
#endif
      {
        for (int i = 0; i < iters; ++i) {
          auto a = std::chrono::steady_clock::now();
          for (size_t k = 0; k < dev_in[0].size(); ++k)
            dev_in[0][k].copy_(host_frames[i % distinct][k]);
          auto b = std::chrono::steady_clock::now();
          std::vector<at::Tensor> outs = run(dev_in[0]);
          auto c = std::chrono::steady_clock::now();
          for (size_t f = 0; f < fetch.size(); ++f)
            host_out[0][f].copy_(outs[fetch[f]]);
          auto d = std::chrono::steady_clock::now();
          legs.h2d_ms += std::chrono::duration<double>(b - a).count() * 1e3;
          legs.exec_ms += std::chrono::duration<double>(c - b).count() * 1e3;
          legs.d2h_ms += std::chrono::duration<double>(d - c).count() * 1e3;
        }
        legs.per_frame_ms = seconds_since(t0) * 1e3 / iters;
      }
      legs.h2d_ms /= iters;
      legs.exec_ms /= iters;
      legs.d2h_ms /= iters;
      return legs;
    };
    std::string stream_json;
    if (pipeline >= 1) {
      const Legs seq = stream_frames(1);
      char buf[512];
      snprintf(buf, sizeof(buf),
               "\"seq_stream_per_frame_ms\": %.6f, \"seq_stream_hz\": %.6f, "
               "\"seq_h2d_ms\": %.6f, \"seq_exec_ms\": %.6f, "
               "\"seq_d2h_ms\": %.6f, ",
               seq.per_frame_ms, 1e3 / seq.per_frame_ms, seq.h2d_ms,
               seq.exec_ms, seq.d2h_ms);
      stream_json += buf;
      fprintf(stderr, "sequential streaming: %.3f ms/frame\n",
              seq.per_frame_ms);
      if (pipeline > 1) {
        const Legs piped = stream_frames(pipeline);
        snprintf(buf, sizeof(buf),
                 "\"pipeline_depth\": %d, \"pipeline_per_frame_ms\": %.6f, "
                 "\"pipeline_hz\": %.6f, \"pipeline_frames\": %d, "
                 "\"pipeline_speedup\": %.6f, ",
                 pipeline, piped.per_frame_ms, 1e3 / piped.per_frame_ms,
                 iters, seq.per_frame_ms / piped.per_frame_ms);
        stream_json += buf;
        fprintf(stderr, "pipelined (depth %d): %.3f ms/frame\n", pipeline,
                piped.per_frame_ms);
      }
    }

    // ---- the frame of set 0: checksums and --dump ----
    std::vector<at::Tensor> outs = run(set0);
    sync();
    std::string outs_json = "[";
    for (size_t o = 0; o < outs.size(); ++o) {
      // every output has the manifest's dtype and dims: the dumps and the
      // streamed frames' buffers are laid out by them
      if (outs[o].scalar_type() != scalar_type(out_specs[o].dtype) ||
          outs[o].sizes() != at::IntArrayRef(out_specs[o].dims))
        throw std::runtime_error(
            "the package's output " + out_specs[o].name + " is " +
            std::string(c10::toString(outs[o].scalar_type())) + " " +
            c10::str(outs[o].sizes()) + ", the manifest says " +
            out_specs[o].dtype + " " + c10::str(out_specs[o].dims));
      const at::Tensor host = outs[o].to(at::kCPU).contiguous();
      const uint8_t* bytes = static_cast<const uint8_t*>(host.data_ptr());
      uint64_t sum = 0;
      for (int64_t i = 0; i < host.nbytes(); ++i) sum = sum * 131 + bytes[i];
      if (!dump_dir.empty()) {
        std::ofstream df(dump_dir + "/" + out_specs[o].name + ".bin",
                         std::ios::binary);
        df.write(reinterpret_cast<const char*>(bytes), host.nbytes());
        if (!df) usage_error("cannot write to " + dump_dir);
      }
      std::string dims;
      for (int64_t k = 0; k < host.dim(); ++k)
        dims += (k ? "," : "") + std::to_string(host.size(k));
      char buf[256];
      snprintf(buf, sizeof(buf),
               "%s{\"name\": \"%s\", \"dims\": [%s], \"checksum\": %llu}",
               o ? ", " : "", out_specs[o].name.c_str(), dims.c_str(),
               (unsigned long long)sum);
      outs_json += buf;
    }
    outs_json += "]";

    printf("{\"per_frame_ms\": %.6f, \"per_frame_p50_ms\": %.6f, "
           "\"hz\": %.6f, \"load_s\": %.6f, \"iters\": %d, "
           "\"distinct\": %d, %s\"device\": \"%s\", \"clock\": \"%s\", "
           "\"tf32\": %s, \"frames_run\": %lld, "
           "\"msfcn_head_launches\": %lld, \"msfcn_head_calls\": %lld, "
           "\"msfcn_head_schema\": \"%s\", \"splat_sums_launches\": %lld, "
           "\"splat_sums_calls\": %lld, \"splat_sums_schema\": \"%s\", "
           "\"outputs\": %s}\n",
           per_frame_ms, p50_ms, 1e3 / per_frame_ms, load_s, iters, distinct,
           stream_json.c_str(), device_name.c_str(),
           cuda ? "cuda_events" : "host", cuda && tf32 ? "true" : "false",
           (long long)frames_run, (long long)creste_msfcn_head_launches(),
           (long long)creste_msfcn_head_calls(), json_escape(schema).c_str(),
           (long long)creste_splat_sums_launches(),
           (long long)creste_splat_sums_calls(),
           json_escape(splat_schema).c_str(), outs_json.c_str());
    fflush(stdout);
  } catch (const std::exception& e) {
    fprintf(stderr, "creste_serve_host: %s\n", e.what());
    return 1;
  }
  return 0;
}
