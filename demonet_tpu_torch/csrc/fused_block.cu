// Fused inverted-residual block, inference: 1x1 expand + folded BN + act,
// 3x3 depthwise (stride 1 or 2, pad 1) + folded BN + act, 1x1 project +
// folded BN, optional residual.
//
// Replaces the TPU kernel demonet_tpu/ops/fused_block.py::
// fused_inverted_residual (_block_kernel, :76; pl.pallas_call, :204).
// Same function, in the port's layout: x (B, CI, H, W) f32 NCHW
// contiguous -> out (B, CO, Ho, Wo), Ho = ceil(H / stride). BN is folded
// into the conv weights and biases by ops/fused_block.py::fold_conv_bn.
// The expanded (B, CE, H, W) map, 3-6x the block's input bytes, never
// reaches device memory.
//
// What bounds it on this card: bytes and fp32 operations together. The
// early MobileNetV3 blocks move tens of MB at b32 and do 2 * CI * CE +
// 18 * CE + 2 * CE * CO operations per pixel: tens of microseconds of
// either at 3.35 TB/s and 67 TFLOP/s.
//
// Design: one block per (image, tile of `th` output rows), one thread per
// output pixel of the tile, the tile chosen so a block has about 256
// threads. The block loads its input rows plus the depthwise halo, all CI
// channels, into shared memory, and the folded weights beside them. Then,
// one expanded channel at a time:
//   1. the block computes the expanded channel over the tile's input rows
//      (a 1x1 product over CI from shared memory, bias, act; zero on rows
//      outside the image, which are the depthwise conv's padding);
//   2. each thread takes the 3x3 depthwise sum at its own pixel, at the
//      stride directly, adds the bias and applies the act;
//   3. and adds that value times the project weights into its CO
//      accumulators, which stay in registers.
// After the last channel each thread adds the project bias (and the
// residual, from the input tile) and writes its CO outputs; neighbouring
// threads write neighbouring pixels of a channel row.
// The 1x1 products are this kernel's own loops (fmaf); no library call.
// Each sum is taken over the same terms as the plain version's convs but
// in another order, so the two agree to fp32 rounding, not bit for bit.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kTargetThreads = 256;
constexpr size_t kMaxSmem = 200 * 1024;

enum Act { kRelu = 0, kRelu6 = 1, kHardSwish = 2 };

__device__ __forceinline__ float activate(float v, int act) {
  if (act == kRelu) return fmaxf(v, 0.0f);
  if (act == kRelu6) return fminf(fmaxf(v, 0.0f), 6.0f);
  return v * (fminf(fmaxf(v + 3.0f, 0.0f), 6.0f) / 6.0f);
}

struct Shape {
  int ci, ce, co, h, w, ho, wo, stride, th, rh, act, residual;
};

// kMaxCO >= co: the output accumulators of one pixel, kept in registers.
template <int kMaxCO>
__global__ void __launch_bounds__(kMaxThreads)
fused_block_kernel(const float* __restrict__ x, const float* __restrict__ we,
                   const float* __restrict__ be, const float* __restrict__ wd,
                   const float* __restrict__ bd, const float* __restrict__ wp,
                   const float* __restrict__ bp, float* __restrict__ out,
                   Shape s) {
  extern __shared__ float smem[];
  const int plane = s.rh * s.w;           // one channel of the input tile
  float* xs = smem;                       // (CI, rh, W) input tile
  float* es = xs + s.ci * plane;          // (rh, W) one expanded channel
  float* swe = es + plane;                // (CE, CI) expand weights
  float* sbe = swe + s.ce * s.ci;         // (CE)
  float* swd = sbe + s.ce;                // (CE, 9) depthwise weights
  float* sbd = swd + s.ce * 9;            // (CE)
  float* swp = sbd + s.ce;                // (CO, CE) project weights

  const bool has_expand = we != nullptr;
  const int img = blockIdx.y;
  const int r0 = blockIdx.x * s.th;       // first output row of the tile
  const int g0 = r0 * s.stride - 1;       // global row of tile row 0
  const float* xb = x + static_cast<int64_t>(img) * s.ci * s.h * s.w;

  for (int t = threadIdx.x; t < s.ci * plane; t += blockDim.x) {
    const int c = t / plane, lr = (t % plane) / s.w, col = t % s.w;
    const int gr = g0 + lr;
    xs[t] = (gr >= 0 && gr < s.h)
                ? xb[(static_cast<int64_t>(c) * s.h + gr) * s.w + col]
                : 0.0f;
  }
  if (has_expand) {
    for (int t = threadIdx.x; t < s.ce * s.ci; t += blockDim.x) swe[t] = we[t];
    for (int t = threadIdx.x; t < s.ce; t += blockDim.x) sbe[t] = be[t];
  }
  for (int t = threadIdx.x; t < s.ce * 9; t += blockDim.x) swd[t] = wd[t];
  for (int t = threadIdx.x; t < s.ce; t += blockDim.x) sbd[t] = bd[t];
  for (int t = threadIdx.x; t < s.co * s.ce; t += blockDim.x) swp[t] = wp[t];
  __syncthreads();

  // this thread's output pixel
  const int lrow = threadIdx.x / s.wo;
  const int ocol = threadIdx.x % s.wo;
  const bool active = lrow < s.th && r0 + lrow < s.ho;
  float acc[kMaxCO];
#pragma unroll
  for (int o = 0; o < kMaxCO; ++o) acc[o] = 0.0f;

  for (int e = 0; e < s.ce; ++e) {
    // 1. expanded channel e over the tile's input rows
    for (int t = threadIdx.x; t < plane; t += blockDim.x) {
      const int gr = g0 + t / s.w;
      float v = 0.0f;
      if (gr >= 0 && gr < s.h) {
        if (has_expand) {
          float sum = 0.0f;
          for (int i = 0; i < s.ci; ++i) {
            sum = fmaf(swe[e * s.ci + i], xs[i * plane + t], sum);
          }
          v = activate(sum + sbe[e], s.act);
        } else {
          v = xs[e * plane + t];
        }
      }
      es[t] = v;
    }
    __syncthreads();
    if (active) {
      // 2. depthwise 3x3 at the stride, zero padding at the W edges
      float dw = 0.0f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const float* erow = es + (lrow * s.stride + dy) * s.w;
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const int c = ocol * s.stride - 1 + dx;
          if (c >= 0 && c < s.w) dw = fmaf(swd[e * 9 + dy * 3 + dx], erow[c], dw);
        }
      }
      dw = activate(dw + sbd[e], s.act);
      // 3. into the project accumulators
#pragma unroll
      for (int o = 0; o < kMaxCO; ++o) {
        if (o < s.co) acc[o] = fmaf(swp[o * s.ce + e], dw, acc[o]);
      }
    }
    __syncthreads();
  }

  if (!active) return;
  const int orow = r0 + lrow;
  float* ob = out + static_cast<int64_t>(img) * s.co * s.ho * s.wo;
#pragma unroll
  for (int o = 0; o < kMaxCO; ++o) {
    if (o < s.co) {
      float v = acc[o] + bp[o];
      if (s.residual) v += xs[o * plane + (lrow + 1) * s.w + ocol];
      ob[(static_cast<int64_t>(o) * s.ho + orow) * s.wo + ocol] = v;
    }
  }
}

size_t smem_bytes(const Shape& s) {
  const size_t plane = static_cast<size_t>(s.rh) * s.w;
  return sizeof(float) *
         (s.ci * plane + plane + static_cast<size_t>(s.ce) * s.ci + s.ce +
          s.ce * 9 + s.ce + static_cast<size_t>(s.co) * s.ce);
}

template <int kMaxCO>
int launch(const float* x, const float* we, const float* be, const float* wd,
           const float* bd, const float* wp, const float* bp, float* out,
           int b, const Shape& s, cudaStream_t stream) {
  const size_t smem = smem_bytes(s);
  const cudaError_t e = cudaFuncSetAttribute(
      fused_block_kernel<kMaxCO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int threads = (s.th * s.wo + 31) / 32 * 32;
  const dim3 grid((s.ho + s.th - 1) / s.th, b);
  fused_block_kernel<kMaxCO><<<grid, threads, smem, stream>>>(
      x, we, be, wd, bd, wp, bp, out, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (b, ci, h, w) f32; we: (ce, ci) f32 and be: (ce) f32, or both null when
// the block has no expand conv (then ce == ci); wd: (ce, 9); bd: (ce);
// wp: (co, ce); bp: (co); out: (b, co, ho, wo), ho = (h - 1) / stride + 1.
// act: 0 relu, 1 relu6, 2 hard-swish. All contiguous on the current
// device; stream is a cudaStream_t. The caller guarantees co <= 128 and
// wo <= 512. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int fused_inverted_residual(
    const void* x, const void* we, const void* be, const void* wd,
    const void* bd, const void* wp, const void* bp, void* out, int b, int ci,
    int ce, int co, int h, int w, int stride, int act, int residual,
    void* stream) {
  Shape s;
  s.ci = ci;
  s.ce = ce;
  s.co = co;
  s.h = h;
  s.w = w;
  s.ho = (h - 1) / stride + 1;
  s.wo = (w - 1) / stride + 1;
  s.stride = stride;
  s.act = act;
  s.residual = residual;
  if (b == 0 || h == 0 || w == 0) return 0;
  if (co > 128 || s.wo > kMaxThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  s.th = kTargetThreads / s.wo;
  if (s.th < 1) s.th = 1;
  if (s.th > s.ho) s.th = s.ho;
  for (;;) {
    s.rh = (s.th - 1) * stride + 3;
    if (smem_bytes(s) <= kMaxSmem || s.th == 1) break;
    --s.th;
  }
  if (smem_bytes(s) > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const auto* xf = static_cast<const float*>(x);
  const auto* wef = static_cast<const float*>(we);
  const auto* bef = static_cast<const float*>(be);
  const auto* wdf = static_cast<const float*>(wd);
  const auto* bdf = static_cast<const float*>(bd);
  const auto* wpf = static_cast<const float*>(wp);
  const auto* bpf = static_cast<const float*>(bp);
  auto* of = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (co <= 16) return launch<16>(xf, wef, bef, wdf, bdf, wpf, bpf, of, b, s, st);
  if (co <= 32) return launch<32>(xf, wef, bef, wdf, bdf, wpf, bpf, of, b, s, st);
  if (co <= 64) return launch<64>(xf, wef, bef, wdf, bdf, wpf, bpf, of, b, s, st);
  return launch<128>(xf, wef, bef, wdf, bdf, wpf, bpf, of, b, s, st);
}
