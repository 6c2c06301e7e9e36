// Greedy NMS keep masks for P independent, score-sorted problems.
//
// Replaces the TPU kernel demonet_tpu/ops/nms_pallas.py::nms_keep_batch
// (_nms_kernel, :40; pl.pallas_call, :139). Same contract: boxes (P, K, 4)
// xyxy f32 and scores (P, K) f32, each problem sorted by descending score;
// candidate i is valid when score > score_threshold; for j > i, j is
// suppressed when i is kept and IoU(i, j) > iou_threshold, with
// IoU = inter / max(area_j + area_i - inter, 1e-9) in f32. Output: the
// (P, K) bool keep mask, bit-equal to the plain version in ops/nms.py.
//
// What bounds it on this card: neither bytes (21 per candidate) nor
// arithmetic (about 14 f32 operations per IoU), but the serial greedy
// chain: step i needs the suppression state left by steps < i. The
// reference postprocess gives P = B * 90 problems of K = 300.
//
// Design: one block per problem. The K candidates go to shared memory as
// structure-of-arrays (x1, y1, x2, y2, area) plus a suppressed byte each:
// 21 bytes * K, 6.3 KB at K = 300. A block reduction finds the end of the
// valid prefix; the loop runs only that far (a trained model leaves most
// problems with a handful of valid candidates). A step whose candidate is
// already suppressed costs no barrier; a kept one has the block test the
// later candidates in parallel, then one __syncthreads. Thousands of small
// blocks run at once, so the serial chains of different problems overlap
// across the 132 SMs.
//
// Exactness: the IoU is written with __fsub_rn/__fmul_rn/__fadd_rn/
// __fdiv_rn in the reference's order, and the library is built with
// -fmad=false, so no FMA contraction rounds differently from the plain
// version at a decision that sits on the threshold.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
nms_keep_kernel(const float4* __restrict__ boxes,
                const float* __restrict__ scores,
                bool* __restrict__ keep, int k, float iou_threshold,
                float score_threshold) {
  extern __shared__ float smem[];
  float* sx1 = smem;
  float* sy1 = sx1 + k;
  float* sx2 = sy1 + k;
  float* sy2 = sx2 + k;
  float* sarea = sy2 + k;
  unsigned char* supp = reinterpret_cast<unsigned char*>(sarea + k);
  __shared__ int s_bound;

  const int64_t base = static_cast<int64_t>(blockIdx.x) * k;
  if (threadIdx.x == 0) s_bound = 0;
  __syncthreads();
  int last = 0;  // 1 + index of this thread's last valid candidate
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    const float4 b = boxes[base + j];
    sx1[j] = b.x;
    sy1[j] = b.y;
    sx2[j] = b.z;
    sy2[j] = b.w;
    sarea[j] = __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
    const bool valid = scores[base + j] > score_threshold;
    supp[j] = !valid;
    if (valid) last = j + 1;
  }
  if (last) atomicMax(&s_bound, last);
  __syncthreads();
  const int bound = s_bound;

  for (int i = 0; i < bound; ++i) {
    // supp[i] was settled by the barrier that closed step i - 1 and no
    // thread writes it in step i, so every thread takes the same branch.
    if (supp[i]) continue;
    const float bx1 = sx1[i], by1 = sy1[i], bx2 = sx2[i], by2 = sy2[i];
    const float barea = sarea[i];
    for (int j = i + 1 + threadIdx.x; j < bound; j += blockDim.x) {
      if (supp[j]) continue;
      const float iw =
          fmaxf(__fsub_rn(fminf(sx2[j], bx2), fmaxf(sx1[j], bx1)), 0.0f);
      const float ih =
          fmaxf(__fsub_rn(fminf(sy2[j], by2), fmaxf(sy1[j], by1)), 0.0f);
      const float inter = __fmul_rn(iw, ih);
      const float uni = __fsub_rn(__fadd_rn(sarea[j], barea), inter);
      const float iou = __fdiv_rn(inter, fmaxf(uni, 1e-9f));
      if (iou > iou_threshold) supp[j] = 1;
    }
    __syncthreads();
  }
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    keep[base + j] = !supp[j];
  }
}

}  // namespace

// boxes: (p, k, 4) f32, 16-byte aligned; scores: (p, k) f32; keep: (p, k)
// bool. All contiguous on the current device; stream is a cudaStream_t.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int nms_keep_batch(const void* boxes, const void* scores,
                              void* keep, int p, int k, float iou_threshold,
                              float score_threshold, void* stream) {
  if (p == 0 || k == 0) return 0;
  const size_t smem = static_cast<size_t>(k) * (5 * sizeof(float) + 1);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        nms_keep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  nms_keep_kernel<<<p, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(scores),
      static_cast<bool*>(keep), k, iou_threshold, score_threshold);
  return static_cast<int>(cudaGetLastError());
}
