// Fused inverted-residual block, inference: 1x1 expand + folded BN + act,
// 3x3 depthwise (stride 1 or 2, pad 1) + folded BN + act, 1x1 project +
// folded BN, and the residual when stride is 1 and CI == CO.
//
// Replaces the TPU kernel demonet_tpu/ops/fused_block.py::
// fused_inverted_residual (_block_kernel, :76; pl.pallas_call, :204).
// Same function, in the JAX kernel's memory order: x is (B, CI, H, W) f32
// channels_last, i.e. NHWC in memory, and out (B, CO, Ho, Wo) channels_last,
// Ho = ceil(H / stride). BN is folded into the conv weights and biases by
// ops/fused_block.py::fold_conv_bn. The expanded (B, CE, H, W) map, 3-6x
// the block's input bytes, never reaches device memory.
//
// What bounds it on this card: bytes. At b32 the MobileNetV3 blocks 0-2
// move 39-105 MB each (12-31 us at 3.35 TB/s), while their 1x1 products,
// done fp32-accurate as three TF32 products, take 9-14 us at the tensor
// cores' 495 TFLOP/s and the depthwise conv and the activations 5-6 us at
// 67 TFLOP/s. On the CUDA cores alone the products would take 40 us, so
// the wide ones go to the tensor cores.
//
// Design. One block of 8 warps per (image, output tile of th x tw pixels);
// ops/fused_block.py::tile_plan picks th, tw and the chunk width ec.
//   - Each tile pixel's source offset in the image is computed once; then
//     the input tile with its halo, ((th-1)*s+3) x ((tw-1)*s+3) pixels of
//     CI channels, is staged into shared memory with 16-byte cp.async
//     copies (a pixel's channels are contiguous in NHWC). Pixels outside
//     the image are zero-filled by the copy itself; they are the depthwise
//     conv's padding (the JAX kernel's row_ok mask), and the expand's
//     output there is forced to zero.
//   - The expanded channels go in chunks of ec (8-32), each in three steps
//     with a barrier after each:
//       1. expand: [input pixels x CI] . [CI x ec] + bias, act, into
//          shared memory (zero outside the image);
//       2. depthwise at the stride: each thread keeps one channel's 9 taps
//          in registers and walks the tile's pixels; + bias, act, into
//          shared memory as [output pixels x ec];
//       3. project: [output pixels x ec] . [ec x CO] accumulated in
//          registers over all chunks. The 8 warps split the tile's 16-row
//          m-tiles and CO's 8-wide n-tiles between them; tile_plan keeps a
//          warp's share at 20 n-tiles (80 accumulators) or fewer.
//     The next chunk's weights are copied (cp.async) into a second buffer
//     while this chunk computes.
//   - Both 1x1 products run on the tensor cores: mma.sync m16n8k8 TF32
//     with each operand split into a TF32 high part and a TF32 low part,
//     and a_hi*b_hi + a_hi*b_lo + a_lo*b_hi summed in fp32. That keeps
//     about 21 bits of each product; plain TF32 keeps 10. The JAX kernel's
//     3x-bf16 split is the same idea. An expand on the CUDA cores (float4
//     shared loads, 4 pixels x 4 channels a thread) tied with it at CI = 16
//     and lost at CI = 24 on the H100 (PERF.md), so it was dropped.
//   - After the last chunk each warp adds the project bias (and the
//     residual, from the staged input tile) to its sums and, where they
//     fit in the shared memory the chunks used, leaves them there, so that
//     the block writes the tile out as whole pixels with 16-byte stores.
// The sums run over the same terms as the plain version's convs but in
// another order, and the split drops the a_lo*b_lo term (about 2^-22 of
// a product): the two agree within 1e-4, not bit for bit.
//
// Measured on the H100 (PERF.md), this design is not yet bound by
// bytes: one tile per block loads, computes and stores in turn, so the
// load latency and the per-tile fixed work are exposed, and the expand's
// operand splits and short mma chains issue at a low rate. A persistent
// block that stages the next tile while computing this one, and wgmma,
// are the next steps.
//
// Limits, which the wrapper checks first and this file checks again:
// th * tw <= 128 and at most 20 n-tiles a warp (the project's sums stay in
// registers: CO <= 640 with the plan's tiles); ec a multiple of 8 up to
// 32; B <= 65,535 (grid.y); the plan's shared memory within the 227 KB a
// block may use.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmemBytes = 232448;
constexpr size_t kSmemPerSm = 233472;  // 228 KB, less 1 KB for each block
constexpr size_t kSmemPerBlockReserved = 1024;
constexpr int kMaxNpw = 20;

enum Act { kRelu = 0, kRelu6 = 1, kHardSwish = 2 };

__device__ __forceinline__ float activate(float v, int act) {
  if (act == kRelu) return fmaxf(v, 0.0f);
  if (act == kRelu6) return fminf(fmaxf(v, 0.0f), 6.0f);
  return v * (fminf(fmaxf(v + 3.0f, 0.0f), 6.0f) / 6.0f);
}

// Everything the kernel needs, derived on the host from the shape and the
// plan by the formulas of ops/fused_block.py::plan_layout. Strides and
// sizes in floats.
struct Params {
  int ci, ce, co, h, w, ho, wo, stride, act, residual, has_expand;
  int th, tw, ec, n_tw, n_chunks;
  int iw, p_in, mp_in;      // input tile: cols, pixels, pixels padded to 16
  int mt_out;               // output tile's 16-row m-tiles
  int ci8, kx, xst;         // X: channels padded to 8, its K extent, row stride
  int es;                   // E and D row stride, and Wp's (ec + 4)
  int wes;                  // We row stride (ci8 + 4)
  int co8, n_nt, wpm, npw;  // CO padded to 8, its n-tiles, warps per m-tile, n-tiles per warp
  int wsz;                  // one weight buffer
  int vec_x, vec_we, vec_wp, vec_out;
  int stage_out;            // the tile's outputs fit where the chunks were
};

// -- PTX helpers ----------------------------------------------------------

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// v = hi + lo + (what the low part's rounding drops), hi and lo TF32
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment (16 x 8, row-major) of m16n8k8 at `base` (row stride
// `stride`), split: lane (g, t) holds (g, t), (g+8, t), (g, t+4), (g+8, t+4).
__device__ __forceinline__ void load_a(const float* base, int stride, int g,
                                       int t, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  const float* p = base + g * stride + t;
  split_tf32(p[0], hi[0], lo[0]);
  split_tf32(p[8 * stride], hi[1], lo[1]);
  split_tf32(p[4], hi[2], lo[2]);
  split_tf32(p[8 * stride + 4], hi[3], lo[3]);
}

// c += a . b for one 16 x 8 tile and one k-step of 8: b (8 x 8) is read
// from rows bn[0 .. 7] of [n][k] at stride `stride` (lane (g, t) holds
// (k = t, n = g) and (k = t + 4, n = g)) and split; the three TF32
// products, the small ones first.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const float* bn, int stride, int g,
                                           int t) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(bn[g * stride + t], bh0, bl0);
  split_tf32(bn[g * stride + t + 4], bh1, bl1);
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

// -- staging --------------------------------------------------------------

// rows x cols (cols a multiple of 4) of dst from a row-major src, zero
// where r >= rows_valid or c >= cols_valid. vec: 16-byte copies (src rows
// 16-byte aligned and cols_valid a multiple of 4).
__device__ __forceinline__ void stage_rows(float* dst, int dst_stride,
                                           int rows, int cols,
                                           const float* src, int src_stride,
                                           int rows_valid, int cols_valid,
                                           bool vec) {
  const int groups = cols / 4;
  for (int i = threadIdx.x; i < rows * groups; i += kThreads) {
    const int r = i / groups, c = (i - r * groups) * 4;
    float* d = dst + r * dst_stride + c;
    const float* s = src + static_cast<int64_t>(r < rows_valid ? r : 0) *
                               src_stride;
    if (vec) {
      const bool ok = r < rows_valid && c < cols_valid;
      cp_async16(d, ok ? s + c : src, ok);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const bool ok = r < rows_valid && c + u < cols_valid;
        cp_async4(d + u, ok ? s + c + u : src, ok);
      }
    }
  }
}

struct Weights {
  float *wp, *wd, *bd, *we, *be;
};

__device__ __forceinline__ Weights weights_at(const Params& p, float* buf) {
  Weights v;
  v.wp = buf;                      // [co8][es]: Wp[o][e0 + e]
  v.wd = v.wp + p.co8 * p.es;      // [9][ec]
  v.bd = v.wd + 9 * p.ec;          // [ec]
  v.we = v.bd + p.ec;              // [ec][wes]: We[e0 + e][ci]
  v.be = v.we + p.ec * p.wes;      // [ec]
  return v;
}

// chunk e0's weights, zero beyond CE (a zero channel adds nothing)
__device__ __forceinline__ void stage_weights(
    const Params& p, float* buf, int e0, const float* we, const float* be,
    const float* wd, const float* bd, const float* wp) {
  const Weights v = weights_at(p, buf);
  const int ev = min(p.ec, p.ce - e0);
  stage_rows(v.wp, p.es, p.co8, p.ec, wp + e0, p.ce, p.co, ev, p.vec_wp);
  for (int i = threadIdx.x; i < 9 * p.ec; i += kThreads) {
    const int tap = i / p.ec, e = i - tap * p.ec;
    cp_async4(v.wd + i, e < ev ? wd + (e0 + e) * 9 + tap : wd, e < ev);
  }
  for (int i = threadIdx.x; i < p.ec; i += kThreads) {
    cp_async4(v.bd + i, i < ev ? bd + e0 + i : bd, i < ev);
  }
  if (p.has_expand) {
    stage_rows(v.we, p.wes, p.ec, p.ci8, we + static_cast<int64_t>(e0) * p.ci,
               p.ci, ev, p.ci, p.vec_we);
    for (int i = threadIdx.x; i < p.ec; i += kThreads) {
      cp_async4(v.be + i, i < ev ? be + e0 + i : be, i < ev);
    }
  }
}

// the image pixel (iy * W + ix) under tile pixel px, or -1 outside
__device__ __forceinline__ int source_pixel(const Params& p, int px, int iy0,
                                            int ix0) {
  if (px >= p.p_in) return -1;
  const int ly = px / p.iw, lx = px - ly * p.iw;
  const int iy = iy0 + ly, ix = ix0 + lx;
  return iy >= 0 && iy < p.h && ix >= 0 && ix < p.w ? iy * p.w + ix : -1;
}

// -- the three steps of a chunk ---------------------------------------------

// 1. expand on the tensor cores: each warp takes m-tiles of 16 input
// pixels, all ec / 8 n-tiles of the chunk
__device__ __forceinline__ void expand_mma(const Params& p, const float* xs,
                                           const Weights& v, float* es,
                                           const int* xoff) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n_nt = p.ec / 8;
  for (int mt = warp; mt < p.mp_in / 16; mt += kWarps) {
    float acc[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n][i] = 0.0f;
    }
    const float* xa = xs + mt * 16 * p.xst;
    for (int k0 = 0; k0 < p.ci8; k0 += 8) {
      uint32_t ah[4], al[4];
      load_a(xa + k0, p.xst, g, t, ah, al);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        if (n < n_nt) {
          mma_3xtf32(acc[n], ah, al, v.we + n * 8 * p.wes + k0, p.wes, g, t);
        }
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int px = mt * 16 + g + half * 8;
      const bool ok = xoff[px] >= 0;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        if (n < n_nt) {
          const int e = n * 8 + 2 * t;
          float2 r;
          r.x = ok ? activate(acc[n][2 * half] + v.be[e], p.act) : 0.0f;
          r.y = ok ? activate(acc[n][2 * half + 1] + v.be[e + 1], p.act) : 0.0f;
          *reinterpret_cast<float2*>(es + px * p.es + e) = r;
        }
      }
    }
  }
}

// 2. depthwise 3x3 at the stride over the expanded chunk `src` (row
// stride ss), into ds [mt_out * 16][es]; rows past the tile are zero.
// Each thread keeps one channel e, its 9 taps and bias in registers, and
// walks the tile's pixels kThreads / ec apart.
__device__ __forceinline__ void depthwise(const Params& p, const float* src,
                                          int ss, const Weights& v,
                                          float* ds) {
  const int qs = kThreads / p.ec;
  int q = threadIdx.x / p.ec;
  if (q >= qs) return;
  const int e = threadIdx.x - q * p.ec;
  float wt[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) wt[k] = v.wd[k * p.ec + e];
  const float bias = v.bd[e];
  const int p_out = p.th * p.tw, mp_out = p.mt_out * 16;
  const int row = p.iw * ss;
  const int dy_q = qs / p.tw, dx_q = qs - dy_q * p.tw;
  int oy = q / p.tw, ox = q - oy * p.tw;
  for (; q < mp_out; q += qs) {
    float r = 0.0f;
    if (q < p_out) {
      const float* s0 =
          src + (oy * p.stride * p.iw + ox * p.stride) * ss + e;
      float sum = 0.0f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        sum = fmaf(s0[0], wt[3 * dy], sum);
        sum = fmaf(s0[ss], wt[3 * dy + 1], sum);
        sum = fmaf(s0[2 * ss], wt[3 * dy + 2], sum);
        s0 += row;
      }
      r = activate(sum + bias, p.act);
    }
    ds[q * p.es + e] = r;
    oy += dy_q;
    ox += dx_q;
    if (ox >= p.tw) {
      ox -= p.tw;
      ++oy;
    }
  }
}

// 3. project: this warp's m-tile `mt` and n-tiles nb .. nb + nn - 1
template <int kNpw>
__device__ __forceinline__ void project(const Params& p, const float* ds,
                                        const Weights& v, int mt, int nb,
                                        int nn, float (&acc)[kNpw][4]) {
  if (nn <= 0) return;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float* da = ds + mt * 16 * p.es;
  for (int k0 = 0; k0 < p.ec; k0 += 8) {
    uint32_t ah[4], al[4];
    load_a(da + k0, p.es, g, t, ah, al);
#pragma unroll
    for (int j = 0; j < kNpw; ++j) {
      if (j < nn) {
        mma_3xtf32(acc[j], ah, al, v.wp + (nb + j) * 8 * p.es + k0, p.es, g,
                   t);
      }
    }
  }
}

// kExpand false: an instance for blocks without an expand conv, which
// needs fewer registers, so more blocks share an SM
template <int kNpw, int kMinBlocks, bool kExpand>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fused_block_kernel(const float* __restrict__ x, const float* __restrict__ we,
                   const float* __restrict__ be, const float* __restrict__ wd,
                   const float* __restrict__ bd, const float* __restrict__ wp,
                   const float* __restrict__ bp, float* __restrict__ out,
                   const Params p) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                                        // [mp_in][xst]
  float* es = xs + p.mp_in * p.xst;                        // [mp_in][es]
  float* ds = es + (p.has_expand ? p.mp_in * p.es : 0);    // [mt_out*16][es]
  float* wbuf = ds + p.mt_out * 16 * p.es;                 // 2 x [wsz]
  int* xoff = reinterpret_cast<int*>(wbuf + 2 * p.wsz);    // [mp_in]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int img = blockIdx.y;
  const int ty = blockIdx.x / p.n_tw, tx = blockIdx.x - ty * p.n_tw;
  const int iy0 = ty * p.th * p.stride - 1, ix0 = tx * p.tw * p.stride - 1;
  const float* xb = x + static_cast<int64_t>(img) * p.h * p.w * p.ci;

  // the input tile, zero outside the image and past CI
  for (int px = threadIdx.x; px < p.mp_in; px += kThreads) {
    xoff[px] = source_pixel(p, px, iy0, ix0);
  }
  __syncthreads();
  const int groups = p.kx / 4;
  for (int i = threadIdx.x; i < p.mp_in * groups; i += kThreads) {
    const int px = i / groups, c = (i - px * groups) * 4;
    float* d = xs + px * p.xst + c;
    const int off = xoff[px];
    const bool pix = off >= 0;
    const float* s = pix ? xb + static_cast<int64_t>(off) * p.ci + c : xb;
    if (p.vec_x) {
      cp_async16(d, pix && c < p.ci ? s : xb, pix && c < p.ci);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const bool ok = pix && c + u < p.ci;
        cp_async4(d + u, ok ? s + u : xb, ok);
      }
    }
  }
  stage_weights(p, wbuf, 0, we, be, wd, bd, wp);
  cp_async_commit();

  // this warp's share of the project
  const int mt = warp / p.wpm;
  const int nb = (warp - mt * p.wpm) * p.npw;
  const int nn = mt < p.mt_out ? min(p.npw, p.n_nt - nb) : 0;
  float acc[kNpw][4];
#pragma unroll
  for (int j = 0; j < kNpw; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.0f;
  }

  for (int c = 0; c < p.n_chunks; ++c) {
    const Weights v = weights_at(p, wbuf + (c & 1) * p.wsz);
    cp_async_wait_all();
    __syncthreads();  // chunk c's weights in; chunk c - 1's project done
    if (c + 1 < p.n_chunks) {
      stage_weights(p, wbuf + ((c + 1) & 1) * p.wsz, (c + 1) * p.ec, we, be,
                    wd, bd, wp);
      cp_async_commit();
    }
    const float* src = xs + c * p.ec;
    int ss = p.xst;
    if (kExpand && p.has_expand) {
      expand_mma(p, xs, v, es, xoff);
      __syncthreads();
      src = es;
      ss = p.es;
    }
    depthwise(p, src, ss, v, ds);
    __syncthreads();
    project<kNpw>(p, ds, v, mt, nb, nn, acc);
  }

  // bias and residual on this warp's outputs; then either into shared
  // memory and out as whole pixel rows (16-byte stores), or, where the
  // tile's outputs do not fit in what the chunks used, straight out
  const int p_out = p.th * p.tw;
  const int ost = p.co8 + 4;
  float* os = es;  // the expanded chunk, depthwise output and weights
  if (p.stage_out) __syncthreads();
#pragma unroll
  for (int j = 0; j < kNpw; ++j) {
    if (j >= nn) continue;
    const int o = (nb + j) * 8 + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int q = mt * 16 + g + half * 8;
      if (q >= p_out) continue;
      const int ry = q / p.tw, rx = q - ry * p.tw;
      const float* res = xs + ((ry + 1) * p.iw + rx + 1) * p.xst;
      float r[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        r[u] = acc[j][2 * half + u] + (o + u < p.co ? bp[o + u] : 0.0f);
        if (p.residual) r[u] += res[o + u];
      }
      if (p.stage_out) {
        *reinterpret_cast<float2*>(os + q * ost + o) = make_float2(r[0], r[1]);
        continue;
      }
      const int oy = ty * p.th + ry, ox = tx * p.tw + rx;
      if (oy >= p.ho || ox >= p.wo) continue;
      float* op = out + ((static_cast<int64_t>(img) * p.ho + oy) * p.wo + ox) *
                            p.co;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (o + u < p.co) op[o + u] = r[u];
      }
    }
  }
  if (!p.stage_out) return;
  __syncthreads();
  const int g4 = (p.co + 3) / 4;
  for (int i = threadIdx.x; i < p_out * g4; i += kThreads) {
    const int q = i / g4, c = (i - q * g4) * 4;
    const int ry = q / p.tw, rx = q - ry * p.tw;
    const int oy = ty * p.th + ry, ox = tx * p.tw + rx;
    if (oy >= p.ho || ox >= p.wo) continue;
    float* op = out + ((static_cast<int64_t>(img) * p.ho + oy) * p.wo + ox) *
                          p.co + c;
    const float* sp = os + q * ost + c;
    if (p.vec_out) {
      *reinterpret_cast<float4*>(op) = *reinterpret_cast<const float4*>(sp);
    } else {
      for (int u = 0; u < 4 && c + u < p.co; ++u) op[u] = sp[u];
    }
  }
}

template <int kNpw, int kMinBlocks, bool kExpand = true>
int launch(const float* x, const float* we, const float* be, const float* wd,
           const float* bd, const float* wp, const float* bp, float* out,
           int b, const Params& p, size_t smem, cudaStream_t stream) {
  auto* kernel = fused_block_kernel<kNpw, kMinBlocks, kExpand>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_th = (p.ho + p.th - 1) / p.th;
  const dim3 grid(n_th * p.n_tw, b);
  kernel<<<grid, kThreads, smem, stream>>>(x, we, be, wd, bd, wp, bp, out, p);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

// The kernel's parameters and shared memory for a shape and a plan, by
// the formulas of ops/fused_block.py::plan_layout (chip_smoke.py checks
// that both give the same bytes, through fused_inverted_residual_smem);
// false beyond a limit.
bool make_params(int ci, int ce, int co, int h, int w, int stride, int act,
                 bool has_expand, int th, int tw, int ec, Params* out,
                 size_t* smem) {
  if ((stride != 1 && stride != 2) || ec < 8 || ec > 32 || ec % 8 != 0 ||
      th < 1 || tw < 1 || th * tw > 128 || ci < 1 || ce < 1 || co < 1 ||
      h < 1 || w < 1 || (!has_expand && ce != ci)) {
    return false;
  }
  Params p;
  p.ci = ci;
  p.ce = ce;
  p.co = co;
  p.h = h;
  p.w = w;
  p.ho = (h - 1) / stride + 1;
  p.wo = (w - 1) / stride + 1;
  p.stride = stride;
  p.act = act;
  p.residual = stride == 1 && ci == co;
  p.has_expand = has_expand;
  p.th = th;
  p.tw = tw;
  p.ec = ec;
  p.n_tw = (p.wo + tw - 1) / tw;
  p.n_chunks = (ce + ec - 1) / ec;
  p.iw = (tw - 1) * stride + 3;
  p.p_in = ((th - 1) * stride + 3) * p.iw;
  p.mp_in = (p.p_in + 15) / 16 * 16;
  p.mt_out = (th * tw + 15) / 16;
  p.ci8 = (ci + 7) / 8 * 8;
  p.kx = p.has_expand ? p.ci8 : p.n_chunks * ec;
  p.xst = p.kx + 4;
  p.es = ec + 4;
  p.wes = p.ci8 + 4;
  p.co8 = (co + 7) / 8 * 8;
  p.n_nt = p.co8 / 8;
  p.wpm = p.mt_out >= kWarps ? 1 : kWarps / p.mt_out;
  p.npw = (p.n_nt + p.wpm - 1) / p.wpm;
  p.wsz = p.co8 * p.es + 10 * ec + (p.has_expand ? ec * p.wes + ec : 0);
  p.vec_x = p.vec_we = p.vec_wp = p.vec_out = 0;
  p.stage_out =
      (p.has_expand ? p.mp_in * p.es : 0) + p.mt_out * 16 * p.es + 2 * p.wsz >=
      p.mt_out * 16 * (p.co8 + 4);
  *smem = sizeof(float) *
          (static_cast<size_t>(p.mp_in) * p.xst +
           (p.has_expand ? static_cast<size_t>(p.mp_in) * p.es : 0) +
           static_cast<size_t>(p.mt_out) * 16 * p.es +
           2 * static_cast<size_t>(p.wsz) + p.mp_in);
  *out = p;
  return p.npw <= kMaxNpw && *smem <= kMaxSmemBytes;
}

// The instance for a warp's share of n-tiles, with the registers a thread
// may take: for CO up to 32 at 128-pixel tiles, 80 (3 blocks an SM) where
// the shared memory lets 3 blocks share an SM and 128 (2) where it does
// not, or 48 (5) without an expand conv; 128 (2) up to CO = 96; 255 (1)
// beyond.
int dispatch(const float* x, const float* we, const float* be,
             const float* wd, const float* bd, const float* wp,
             const float* bp, float* out, int b, const Params& p, size_t smem,
             cudaStream_t st) {
  if (p.npw <= 4 && !p.has_expand) {
    return launch<4, 5, false>(x, we, be, wd, bd, wp, bp, out, b, p, smem, st);
  }
  if (p.npw <= 4 && 3 * (smem + kSmemPerBlockReserved) <= kSmemPerSm) {
    return launch<4, 3>(x, we, be, wd, bd, wp, bp, out, b, p, smem, st);
  }
  if (p.npw <= 4) {
    return launch<4, 2>(x, we, be, wd, bd, wp, bp, out, b, p, smem, st);
  }
  if (p.npw <= 8) {
    return launch<8, 2>(x, we, be, wd, bd, wp, bp, out, b, p, smem, st);
  }
  if (p.npw <= 12) {
    return launch<12, 2>(x, we, be, wd, bd, wp, bp, out, b, p, smem, st);
  }
  return launch<20, 1>(x, we, be, wd, bd, wp, bp, out, b, p, smem, st);
}

}  // namespace

// x: (b, h, w, ci) f32 in memory (channels_last); we: (ce, ci) and be:
// (ce), or both null when the block has no expand conv (then ce == ci);
// wd: (ce, 9); bd: (ce); wp: (co, ce); bp: (co); out: (b, ho, wo, co) in
// memory, ho = (h - 1) / stride + 1. act: 0 relu, 1 relu6, 2 hard-swish.
// The plan (th, tw, ec) is ops/fused_block.py::tile_plan's. All on the
// current device; stream is a cudaStream_t. Returns cudaErrorInvalidValue
// for a plan or shape beyond the limits above, else cudaGetLastError()
// after the launch (0 on success).
extern "C" int fused_inverted_residual(
    const void* x, const void* we, const void* be, const void* wd,
    const void* bd, const void* wp, const void* bp, void* out, int b, int ci,
    int ce, int co, int h, int w, int stride, int act, int th, int tw, int ec,
    void* stream) {
  if (b == 0 || h == 0 || w == 0) return 0;
  Params p;
  size_t smem = 0;
  if (b > 65535 || !make_params(ci, ce, co, h, w, stride, act, we != nullptr,
                                th, tw, ec, &p, &smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.vec_x = ci % 4 == 0 && aligned16(x);
  p.vec_we = p.has_expand && ci % 4 == 0 && aligned16(we);
  p.vec_wp = ce % 4 == 0 && aligned16(wp);
  p.vec_out = co % 4 == 0 && aligned16(out);
  return dispatch(static_cast<const float*>(x), static_cast<const float*>(we),
                  static_cast<const float*>(be), static_cast<const float*>(wd),
                  static_cast<const float*>(bd), static_cast<const float*>(wp),
                  static_cast<const float*>(bp), static_cast<float*>(out), b,
                  p, smem, static_cast<cudaStream_t>(stream));
}

// The dynamic shared memory in bytes that a launch with this shape and
// plan asks for, or -1 beyond a limit; no device call.
extern "C" int fused_inverted_residual_smem(int ci, int ce, int co, int h,
                                            int w, int stride, int has_expand,
                                            int th, int tw, int ec) {
  Params p;
  size_t smem = 0;
  if (!make_params(ci, ce, co, h, w, stride, 0, has_expand != 0, th, tw, ec,
                   &p, &smem)) {
    return -1;
  }
  return static_cast<int>(smem);
}
