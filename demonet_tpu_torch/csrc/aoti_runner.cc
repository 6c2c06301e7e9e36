// aoti_runner: run an exported detector with no Python.
//
// Counterpart of cpp/pjrt_runner.cc. The artifact is an AOTInductor package
// written by demonet_tpu_torch/export/aoti.py::package_detector (or the
// export CLI's --aoti): preprocess, trunk, heads and postprocess compiled
// ahead of time, its weights inside. The runtime is the libtorch that ships
// in the torch wheel.
//
// Usage:
//   aoti_runner <package.pt2> <NxHxWxC> [iters] [ops=<lib>]
//               [input_file=<raw f32>] [dump_out=<prefix>]
//   e.g. aoti_runner ssdlite320.pt2 1x320x320x3 50 ops=aoti_ops-cuda.so
//
// ops= is loaded first (RTLD_NOW | RTLD_GLOBAL): the library of
// csrc/aoti_ops.cc, which registers K1, K2 and K3 from C++. A package whose
// graph holds them cannot run without it. The input goes to the package's
// own device (its metadata); a CUDA package where no GPU is visible is an
// error. It is zeros, or the raw float32 of input_file= (its size checked).
// cuDNN runs with TF32 off, its deterministic algorithms and no benchmark
// search, so the runner and a Python call under the same settings run the
// same convolutions. After 3 warm-up calls it times `iters` calls (default
// 10); each ends with a copy of every output to the host, the honest
// completion barrier. dump_out= writes each output of the first call,
// dense and row-major, to <prefix>.<i>.bin, in the package's flattened
// output order. It prints the outputs' shapes and dtypes, the times, the
// ops library's counts of K1, K2 and K3 per call and the number of calls
// (warm-up included), and OK. Any error exits 1.

#include <dlfcn.h>

#include <ATen/ATen.h>
#include <torch/csrc/inductor/aoti_package/model_package_loader.h>
#include <torch/cuda.h>

#include <algorithm>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <iterator>
#include <map>
#include <sstream>
#include <string>
#include <vector>

namespace {

constexpr int kWarmup = 3;

using LaunchesFn = int64_t (*)(const char*, const char*);

const char* const kCounters[] = {"nms_keep_batch", "nms_keep_batch.block",
                                 "nms_keep_batch.tiled", "nms_keep_batch.long",
                                 "gather_rows_batch", "topk_sparse",
                                 "topk_sparse.long",
                                 "topk_sparse.class_tile"};

std::vector<int64_t> ParseDims(const std::string& spec) {
  std::vector<int64_t> dims;
  std::stringstream ss(spec);
  std::string part;
  while (std::getline(ss, part, 'x')) dims.push_back(std::stoll(part));
  return dims;
}

std::string Shape(const at::Tensor& t) {
  std::string s;
  for (int64_t i = 0; i < t.dim(); ++i) {
    s += (i ? "x" : "") + std::to_string(t.size(i));
  }
  return s.empty() ? "scalar" : s;
}

// the counts of the ops library on `device`, by counter name
std::map<std::string, int64_t> Counts(LaunchesFn launches,
                                      const std::string& device) {
  std::map<std::string, int64_t> out;
  for (const char* name : kCounters) {
    const int64_t n = launches(name, device.c_str());
    if (n >= 0) out[name] = n;
  }
  return out;
}

std::string Format(const std::map<std::string, int64_t>& counts) {
  std::string s;
  for (const auto& kv : counts) {
    s += " " + kv.first + "=" + std::to_string(kv.second);
  }
  return s;
}

int Run(int argc, char** argv) {
  if (argc < 3) {
    std::fprintf(stderr,
                 "usage: %s <package.pt2> <NxHxWxC> [iters] [ops=<lib>] "
                 "[input_file=<raw f32>] [dump_out=<prefix>]\n",
                 argv[0]);
    return 1;
  }
  const std::string package = argv[1];
  const std::vector<int64_t> dims = ParseDims(argv[2]);
  int iters = 10;
  std::string ops, input_file, dump_prefix;
  for (int i = 3; i < argc; ++i) {
    const std::string arg = argv[i];
    if (arg.rfind("ops=", 0) == 0) {
      ops = arg.substr(4);
    } else if (arg.rfind("input_file=", 0) == 0) {
      input_file = arg.substr(11);
    } else if (arg.rfind("dump_out=", 0) == 0) {
      dump_prefix = arg.substr(9);
    } else if (arg.find('=') == std::string::npos) {
      iters = std::stoi(arg);
    } else {
      std::fprintf(stderr, "unknown argument %s\n", arg.c_str());
      return 1;
    }
  }
  if (iters < 1) {
    std::fprintf(stderr, "iters must be at least 1, got %d\n", iters);
    return 1;
  }

  // --- the ops library, before the package that calls its ops ---
  LaunchesFn launches = nullptr;
  if (!ops.empty()) {
    void* handle = dlopen(ops.c_str(), RTLD_NOW | RTLD_GLOBAL);
    if (handle == nullptr) {
      std::fprintf(stderr, "cannot load ops library %s: %s\n", ops.c_str(),
                   dlerror());
      return 1;
    }
    launches = reinterpret_cast<LaunchesFn>(
        dlsym(handle, "demonet_tpu_torch_launches"));
    if (launches == nullptr) {
      std::fprintf(stderr, "%s has no demonet_tpu_torch_launches\n",
                   ops.c_str());
      return 1;
    }
    std::printf("ops: %s\n", ops.c_str());
  }

  // --- the package's device, from its metadata ---
  const auto metadata =
      torch::inductor::AOTIModelPackageLoader::load_metadata_from_package(
          package, "model");
  const auto key = metadata.find("AOTI_DEVICE_KEY");
  if (key == metadata.end()) {
    std::fprintf(stderr, "%s names no device (AOTI_DEVICE_KEY)\n",
                 package.c_str());
    return 1;
  }
  const std::string device_type = key->second;
  if (device_type != "cpu" && device_type != "cuda") {
    std::fprintf(stderr, "%s is a package for %s: this runner takes cpu or "
                 "cuda\n", package.c_str(), device_type.c_str());
    return 1;
  }
  if (device_type == "cuda" && !torch::cuda::is_available()) {
    std::fprintf(stderr, "%s is a CUDA package and no CUDA device is "
                 "visible to this process\n", package.c_str());
    return 1;
  }
  const c10::Device device(device_type);
  std::printf("device: %s\n", device_type.c_str());
  auto& ctx = at::globalContext();
  ctx.setAllowTF32CuDNN(false);
  ctx.setAllowTF32CuBLAS(false);
  ctx.setDeterministicCuDNN(true);
  ctx.setBenchmarkCuDNN(false);
  std::printf("cudnn: tf32 off, deterministic, no benchmark\n");

  auto t0 = std::chrono::steady_clock::now();
  torch::inductor::AOTIModelPackageLoader loader(package);
  std::printf("loaded in %.1f ms\n",
              std::chrono::duration<double, std::milli>(
                  std::chrono::steady_clock::now() - t0)
                  .count());

  // --- the input: zeros, or raw float32 ---
  int64_t numel = 1;
  for (int64_t d : dims) numel *= d;
  std::vector<float> host_input(static_cast<size_t>(numel), 0.0f);
  if (!input_file.empty()) {
    std::ifstream f(input_file, std::ios::binary);
    if (!f) {
      std::fprintf(stderr, "cannot read input_file %s\n", input_file.c_str());
      return 1;
    }
    std::string raw((std::istreambuf_iterator<char>(f)),
                    std::istreambuf_iterator<char>());
    if (raw.size() != host_input.size() * sizeof(float)) {
      std::fprintf(stderr, "input_file %s has %zu bytes, want %zu\n",
                   input_file.c_str(), raw.size(),
                   host_input.size() * sizeof(float));
      return 1;
    }
    std::memcpy(host_input.data(), raw.data(), raw.size());
  }
  const at::Tensor input =
      at::from_blob(host_input.data(), dims, at::kFloat).to(device);

  // --- warm-up and timed calls, each ending with every output on the host
  std::vector<double> iter_ms;
  std::vector<std::map<std::string, int64_t>> per_call;
  for (int i = 0; i < kWarmup + iters; ++i) {
    const auto before = launches ? Counts(launches, device_type)
                                 : std::map<std::string, int64_t>{};
    const auto it0 = std::chrono::steady_clock::now();
    std::vector<at::Tensor> outputs = loader.run({input});
    std::vector<at::Tensor> host(outputs.size());
    for (size_t o = 0; o < outputs.size(); ++o) {
      host[o] = outputs[o].to(at::kCPU).contiguous();
    }
    const double ms = std::chrono::duration<double, std::milli>(
                          std::chrono::steady_clock::now() - it0)
                          .count();
    if (launches) {
      auto delta = Counts(launches, device_type);
      for (auto& kv : delta) kv.second -= before.at(kv.first);
      per_call.push_back(delta);
    }
    if (i == 0) {
      std::printf("outputs: %zu\n", host.size());
      for (size_t o = 0; o < host.size(); ++o) {
        std::printf("output[%zu]: shape %s dtype %s bytes %zu\n", o,
                    Shape(host[o]).c_str(),
                    std::string(c10::toString(host[o].scalar_type())).c_str(),
                    host[o].nbytes());
        if (dump_prefix.empty()) continue;
        const std::string path =
            dump_prefix + "." + std::to_string(o) + ".bin";
        std::ofstream of(path, std::ios::binary);
        of.write(static_cast<const char*>(host[o].data_ptr()),
                 static_cast<std::streamsize>(host[o].nbytes()));
        if (!of) {
          std::fprintf(stderr, "cannot write %s\n", path.c_str());
          return 1;
        }
        std::printf("dumped output[%zu] -> %s\n", o, path.c_str());
      }
    }
    if (i >= kWarmup) iter_ms.push_back(ms);
  }

  double total_ms = 0.0;
  for (double ms : iter_ms) total_ms += ms;
  std::sort(iter_ms.begin(), iter_ms.end());
  std::printf("ran %d iters: best %.3f ms, p50 %.3f ms, mean %.3f ms\n",
              iters, iter_ms.front(), iter_ms[iter_ms.size() / 2],
              total_ms / iters);
  if (launches) {
    // every call of one input launches the same kernels
    for (const auto& c : per_call) {
      if (c != per_call.front()) {
        std::fprintf(stderr, "launches per call vary:%s against%s\n",
                     Format(c).c_str(), Format(per_call.front()).c_str());
        return 1;
      }
    }
    std::printf("launches per call (%s):%s\n", device_type.c_str(),
                Format(per_call.front()).c_str());
    std::printf("calls: %zu\n", per_call.size());
  }
  std::printf("OK\n");
  return 0;
}

}  // namespace

int main(int argc, char** argv) {
  try {
    return Run(argc, argv);
  } catch (const std::exception& e) {
    std::fprintf(stderr, "aoti_runner: %s\n", e.what());
    return 1;
  }
}
