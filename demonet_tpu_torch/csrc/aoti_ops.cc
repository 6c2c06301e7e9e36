// K1 and K2 as C++ operators, for a process with no Python: the C++
// runner (aoti_runner.cc) loads this library before an AOTInductor package
// whose graph holds the ops `demonet_tpu_torch::nms_keep_batch` and
// `::gather_rows_batch`.
//
// In Python the same ops are `torch.library.custom_op`s
// (ops/library.py). A package calls its ops through the dispatcher by
// name, and a process with no Python has no Python op to find: it aborts
// with "Could not find schema". This library registers the two ops from
// C++, with the Python ops' schemas letter for letter, so a package made
// in Python runs here unchanged. Never load it into a Python process that
// has imported demonet_tpu_torch.ops: the namespace would be defined twice.
//
// CUDA implementations call the C entry points of csrc/nms.cu and
// csrc/gather.cu, linked from the libraries that ops/_build.py builds from
// those sources, with the checks of ops/nms.py::nms_keep_batch_cuda and
// ops/gather.py::gather_rows_batch_cuda, on the current stream; K1's launch
// shape and scratch are nms.cu's own choice (`nms_launch_shape`,
// `nms_scratch_words`), which the Python wrapper takes too. A launch that
// returns a CUDA error raises with its cudaError_t. CPU implementations transcribe the plain versions
// (ops/nms.py::nms_keep_batch_plain, ops/gather.py::gather_rows_batch_plain)
// ATen op by ATen op, in their order, so their results are bit-equal.
//
// K3 (`topk_sparse`) is left out: no exported program reaches it, as the
// JAX export passes no top-k implementation (export/program.py).
//
// Each op counts its calls per device, K1's CUDA launches also per launch
// shape; `demonet_tpu_torch_launches` reads a count.
//
// Build: DEMONET_WITH_CUDA adds the CUDA implementations
// (export/aoti.py::build_runner).

#include <ATen/ATen.h>
#include <torch/library.h>

#include <atomic>
#include <cstdint>
#include <cstring>
#include <string>

#ifdef DEMONET_WITH_CUDA
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>

extern "C" int nms_launch_shape(int k);
extern "C" long long nms_scratch_words(int p, int k, int launch);
extern "C" int nms_keep_batch(const void* boxes, const void* scores,
                              void* keep, void* scratch, int p, int k,
                              float iou_threshold, float score_threshold,
                              int launch, void* stream);
extern "C" int gather_rows_batch(const void* table, const void* idx,
                                 void* out, int b, int n, int r,
                                 int coord_major, void* stream);
#endif

namespace {

enum Counter {
  kNmsCpu, kGatherCpu, kNmsCuda, kNmsBlock, kNmsTiled, kNmsLong, kGatherCuda,
  kCounters
};
std::atomic<int64_t> g_counts[kCounters];

at::Tensor nms_keep_batch_cpu(const at::Tensor& boxes,
                              const at::Tensor& scores, double iou_threshold,
                              double score_threshold) {
  g_counts[kNmsCpu] += 1;
  const int64_t p = boxes.size(0), k = boxes.size(1);
  at::Tensor valid = scores > score_threshold;
  auto xyxy = boxes.unbind(-1);
  const at::Tensor &x1 = xyxy[0], &y1 = xyxy[1], &x2 = xyxy[2],
                   &y2 = xyxy[3];
  at::Tensor area = (x2 - x1) * (y2 - y1);
  at::Tensor suppressed = ~valid;
  at::Tensor later = at::arange(k, boxes.options().dtype(at::kLong));
  // the loop ends after the last valid candidate of any problem
  const int64_t bound =
      p * k ? (valid * (later + 1)).amax().item<int64_t>() : 0;
  for (int64_t i = 0; i < bound; ++i) {
    at::Tensor kept_i = ~suppressed.slice(1, i, i + 1);
    at::Tensor iw = at::clamp(at::minimum(x2, x2.slice(1, i, i + 1)) -
                                  at::maximum(x1, x1.slice(1, i, i + 1)),
                              0.0, std::nullopt);
    at::Tensor ih = at::clamp(at::minimum(y2, y2.slice(1, i, i + 1)) -
                                  at::maximum(y1, y1.slice(1, i, i + 1)),
                              0.0, std::nullopt);
    at::Tensor inter = iw * ih;
    at::Tensor iou =
        inter / at::clamp(area + area.slice(1, i, i + 1) - inter, 1e-9,
                          std::nullopt);
    suppressed.bitwise_or_(kept_i & (iou > iou_threshold) & (later > i));
  }
  return ~suppressed;
}

at::Tensor gather_rows_batch_cpu(const at::Tensor& table,
                                 const at::Tensor& idx, bool coord_major) {
  g_counts[kGatherCpu] += 1;
  const int64_t d = table.size(-1);
  at::Tensor out =
      at::gather(table, 1, idx.to(at::kLong).unsqueeze(-1).expand({-1, -1, d}));
  return coord_major ? out.transpose(1, 2).contiguous() : out;
}

#ifdef DEMONET_WITH_CUDA
void check_launch(int code, const char* kernel) {
  TORCH_CHECK(code == 0, "CUDA kernel ", kernel,
              " failed to launch: cudaError_t ", code);
}

at::Tensor nms_keep_batch_cuda(const at::Tensor& boxes,
                               const at::Tensor& scores, double iou_threshold,
                               double score_threshold) {
  TORCH_CHECK(boxes.is_contiguous() && scores.is_contiguous(),
              "nms_keep_batch: boxes and scores must be contiguous");
  TORCH_CHECK(reinterpret_cast<uintptr_t>(boxes.data_ptr()) % 16 == 0,
              "nms_keep_batch: boxes must be 16-byte aligned");
  const int64_t p = boxes.size(0), k = boxes.size(1);
  const int launch = ::nms_launch_shape(static_cast<int>(k));
  const int64_t words =
      ::nms_scratch_words(static_cast<int>(p), static_cast<int>(k), launch);
  c10::cuda::CUDAGuard guard(boxes.device());
  at::Tensor keep = at::empty({p, k}, boxes.options().dtype(at::kBool));
  at::Tensor scratch;
  if (words > 0) {  // the IoU bitmask of the tiled and long launches
    scratch = at::empty({words}, boxes.options().dtype(at::kLong));
  }
  const int code = ::nms_keep_batch(
      boxes.data_ptr(), scores.data_ptr(), keep.data_ptr(),
      words > 0 ? scratch.data_ptr() : nullptr, static_cast<int>(p),
      static_cast<int>(k), static_cast<float>(iou_threshold),
      static_cast<float>(score_threshold), launch,
      c10::cuda::getCurrentCUDAStream(boxes.device().index()).stream());
  check_launch(code, "nms_keep_batch");
  g_counts[kNmsCuda] += 1;
  g_counts[launch == 1 ? kNmsBlock : (launch == 2 ? kNmsTiled : kNmsLong)] +=
      1;
  return keep;
}

at::Tensor gather_rows_batch_cuda(const at::Tensor& table,
                                  const at::Tensor& idx, bool coord_major) {
  TORCH_CHECK(table.is_contiguous() && idx.is_contiguous(),
              "gather_rows_batch: table and idx must be contiguous");
  TORCH_CHECK(reinterpret_cast<uintptr_t>(table.data_ptr()) % 16 == 0,
              "gather_rows_batch: table must be 16-byte aligned");
  const int64_t b = table.size(0), n = table.size(1), d = table.size(2);
  const int64_t r = idx.size(1);
  c10::cuda::CUDAGuard guard(table.device());
  at::Tensor out = coord_major ? at::empty({b, d, r}, table.options())
                               : at::empty({b, r, d}, table.options());
  const int code = ::gather_rows_batch(
      table.data_ptr(), idx.data_ptr(), out.data_ptr(), static_cast<int>(b),
      static_cast<int>(n), static_cast<int>(r), coord_major ? 1 : 0,
      c10::cuda::getCurrentCUDAStream(table.device().index()).stream());
  check_launch(code, "gather_rows_batch");
  g_counts[kGatherCuda] += 1;
  return out;
}
#endif

}  // namespace

TORCH_LIBRARY(demonet_tpu_torch, m) {
  m.def("nms_keep_batch(Tensor boxes, Tensor scores, float iou_threshold, "
        "float score_threshold) -> Tensor");
  m.def("gather_rows_batch(Tensor table, Tensor idx, bool coord_major) -> "
        "Tensor");
}

TORCH_LIBRARY_IMPL(demonet_tpu_torch, CPU, m) {
  m.impl("nms_keep_batch", &nms_keep_batch_cpu);
  m.impl("gather_rows_batch", &gather_rows_batch_cpu);
}

#ifdef DEMONET_WITH_CUDA
TORCH_LIBRARY_IMPL(demonet_tpu_torch, CUDA, m) {
  m.impl("nms_keep_batch", &nms_keep_batch_cuda);
  m.impl("gather_rows_batch", &gather_rows_batch_cuda);
}
#endif

// The count of `name` on `device` since the library was loaded: name
// "nms_keep_batch" or "gather_rows_batch" on "cpu" or "cuda", or
// "nms_keep_batch.block", ".tiled", ".long" on "cuda" (K1 by launch shape).
// -1 for any other pair.
extern "C" int64_t demonet_tpu_torch_launches(const char* name,
                                              const char* device) {
  static const struct {
    const char* name;
    const char* device;
    Counter counter;
  } kNames[] = {
      {"nms_keep_batch", "cpu", kNmsCpu},
      {"gather_rows_batch", "cpu", kGatherCpu},
      {"nms_keep_batch", "cuda", kNmsCuda},
      {"nms_keep_batch.block", "cuda", kNmsBlock},
      {"nms_keep_batch.tiled", "cuda", kNmsTiled},
      {"nms_keep_batch.long", "cuda", kNmsLong},
      {"gather_rows_batch", "cuda", kGatherCuda},
  };
  for (const auto& e : kNames) {
    if (std::strcmp(e.name, name) == 0 && std::strcmp(e.device, device) == 0) {
      return g_counts[e.counter].load();
    }
  }
  return -1;
}
