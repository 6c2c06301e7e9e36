// Exact top-k of thresholded score rows: chunk skipping for sparse rows, a
// radix select for dense ones.
//
// Replaces the TPU kernel demonet_tpu/ops/topk_pallas.py::topk_sparse
// (_topk_kernel, :100; _bitonic_sort_desc, :67; pl.pallas_call, :157).
// Contract: scores (P, A) f32, one row per (image, class); for each row the
// first k of a stable descending sort of where(x > thresh, x, -inf), with
// ties in ascending index order as lax.top_k gives them. Every slot whose
// score is not above thresh is padding, written as (-inf, index 0). Output
// (P, k) f32 + (P, k) int32, bit-equal on every entry to the plain version
// in ops/topk.py.
//
// What bounds it on this card: bytes. Every score is read once (37 MB at
// b32 on ssdlite320: P = 32 * 90 rows of A = 3,234) and 8 bytes per output
// slot are written. A dense row (a softmax leaves most (image, class) rows
// of a COCO model above score_thresh = 0.001) must not cost more on chip
// than that read: sorting the whole row (4,096 entries, 78 barrier-
// separated stages) to keep 300 of them did, 50x the bound.
//
// Design: one block of 256 threads per row. Warp w holds the 128-wide
// chunks [4w, 4w + 4) of the row (fewer for short rows) in registers, 16
// scores a thread at most (A <= 4,096), read from device memory once and
// never again.
//   1. A ballot per 32 scores says which are above thresh; OR-ed over a
//      chunk it flags the chunk, and warp 0's ballot over the chunk flags
//      gives each live chunk its slot (a popcount of the lower bits).
//   2. A row with no live chunk writes padding and exits (most rows of a
//      trained model).
//   3. Compact: a row with at most `slots` live chunks writes them from
//      registers, in slot order, into a shared buffer of next_pow2(live
//      chunks * 128) entries, each with its global index, and sorts it.
//   4. Select: a row with more live chunks finds the k-th largest key T by
//      radix select, takes the k entries at or above it and sorts only
//      those (a buffer of next_pow2(k), 512 for k = 300).
//      - Keys: each live score maps to an order-preserving uint32 (all bits
//        of a negative flipped, the sign bit of a positive set; -0.0 folded
//        onto +0.0 first), so key order is float `>` order. What is
//        written out is the score itself.
//      - Four passes of 8-bit digits, most significant first, over the
//        registers. Each warp counts into its own 256-bin histogram in
//        shared memory, one atomic per distinct digit of the 32 lanes
//        (__match_any_sync): softmax scores crowd into a few exponent bins,
//        which would serialise the atomics of one shared histogram. A
//        suffix scan over the 256 bins picks the digit and the rank left
//        inside it.
//      - A row with at most k live entries skips the select (T is the key
//        of -inf, no ties to cut) and compacts its live entries directly.
//   5. The bitonic sort orders (score descending, index ascending); the
//      first k entries are written, dead ones as padding.
//
// Exactness of the tie cut: the select leaves T and r, the number of
// entries equal to T that belong to the top k; k - r entries lie above T.
// The kept set is every live entry with key > T and the first r with key
// == T in ascending index order, which is the first k of the stable sort.
// The index order is counted without atomics: warp w owns a contiguous
// range of the row, so a per-warp count of the entries equal to T, a
// prefix over the 8 warps and a running popcount of ballots inside the
// warp give each entry its rank among the ties and its slot in the buffer.
// The sort then sees distinct (score, index) pairs (padding carries indices
// >= A), a total order, so the result does not depend on where in the
// buffer an entry landed.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 128;
constexpr int kMaxChunks = 32;
constexpr int kMaxIters = kMaxChunks * kChunk / kThreads;  // 16 per thread
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kDeadKey = 0x007fffffu;  // order_key(-inf)

// Order-preserving map of a float onto uint32: a > b iff key(a) > key(b)
// for every non-NaN pair, -0.0 and +0.0 alike.
__device__ __forceinline__ uint32_t order_key(float x) {
  uint32_t u = __float_as_uint(x);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// (ka, ia) comes before (kb, ib) in the output order.
__device__ __forceinline__ bool before(float ka, int ia, float kb, int ib) {
  return ka > kb || (ka == kb && ia < ib);
}

__device__ __forceinline__ int next_pow2_dev(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// Sort n (a power of two) pairs in shared memory: key descending, index
// ascending on equal keys. Ends with a barrier.
__device__ void bitonic_sort(float* key, int* idx, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < n / 2; t += blockDim.x) {
        const int i = 2 * t - (t & (stride - 1));  // lower element of a pair
        const int j = i + stride;
        const bool desc = (i & size) == 0;
        const float ki = key[i], kj = key[j];
        const int ii = idx[i], ij = idx[j];
        if (before(kj, ij, ki, ii) == desc) {
          key[i] = kj;
          key[j] = ki;
          idx[i] = ij;
          idx[j] = ii;
        }
      }
      __syncthreads();
    }
  }
}

__global__ void __launch_bounds__(kThreads)
topk_sparse_kernel(const float* __restrict__ scores, float* __restrict__ out_sc,
                   int* __restrict__ out_idx, int a, int k, float thresh,
                   int slots, int warp_span) {
  extern __shared__ float smem[];
  __shared__ unsigned s_hist[kWarps][256];
  __shared__ int s_live[kMaxChunks];
  __shared__ int s_slot[kMaxChunks];
  __shared__ int s_warp_a[kWarps];
  __shared__ int s_warp_b[kWarps];
  __shared__ int s_scan[kWarps];
  __shared__ int s_n_chunks, s_n_live, s_digit, s_rank;

  const float neg_inf = -CUDART_INF_F;
  const int chunks = (a + kChunk - 1) / kChunk;
  const float* row = scores + static_cast<int64_t>(blockIdx.x) * a;
  float* osc = out_sc + static_cast<int64_t>(blockIdx.x) * k;
  int* oidx = out_idx + static_cast<int64_t>(blockIdx.x) * k;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lower = (1u << lane) - 1u;
  const int iters = warp_span / 32;  // a multiple of 4: whole chunks
  const int col0 = warp * warp_span + lane;

  // 1. the row into registers; live entries and live chunks by ballot
  float x[kMaxIters];
  int n_live = 0;
  unsigned chunk_hit = 0u;
#pragma unroll
  for (int i = 0; i < kMaxIters; ++i) {
    const int col = col0 + i * 32;
    x[i] = (i < iters && col < a) ? row[col] : neg_inf;
  }
#pragma unroll
  for (int i = 0; i < kMaxIters; ++i) {
    const unsigned hit = __ballot_sync(kFull, x[i] > thresh);
    n_live += __popc(hit);
    chunk_hit |= hit;
    if ((i & 3) == 3) {
      const int c = (warp * warp_span + (i - 3) * 32) / kChunk;
      if (lane == 0 && i < iters) s_live[c] = chunk_hit != 0u;
      chunk_hit = 0u;
    }
  }
  for (int d = lane; d < 256; d += 32) s_hist[warp][d] = 0u;
  if (lane == 0) s_warp_a[warp] = n_live;
  __syncthreads();
  if (warp == 0) {
    const bool live = lane < chunks && s_live[lane];
    const unsigned mask = __ballot_sync(kFull, live);
    if (live) s_slot[lane] = __popc(mask & lower);
    int total = lane < kWarps ? s_warp_a[lane] : 0;
    for (int off = 16; off > 0; off >>= 1) {
      total += __shfl_xor_sync(kFull, total, off);
    }
    if (lane == 0) {
      s_n_chunks = __popc(mask);
      s_n_live = total;
    }
  }
  __syncthreads();
  const int n_chunks = s_n_chunks;
  n_live = s_n_live;

  // 2. nothing above thresh: all padding
  if (n_chunks == 0) {
    for (int j = threadIdx.x; j < k; j += kThreads) {
      osc[j] = neg_inf;
      oidx[j] = 0;
    }
    return;
  }

  float* key = smem;
  int* idx = reinterpret_cast<int*>(smem) + next_pow2_dev(
      max(min(slots, chunks) * kChunk, k));
  int count, width;
  if (n_chunks <= slots) {
    // 3. compact: the live chunks, dead entries and all, in slot order
    count = n_chunks * kChunk;
    width = next_pow2_dev(count);
#pragma unroll
    for (int i = 0; i < kMaxIters; ++i) {
      const int col = col0 + i * 32;
      const int c = col / kChunk;
      if (i < iters && c < chunks && s_live[c]) {
        const int pos = s_slot[c] * kChunk + col % kChunk;
        key[pos] = x[i] > thresh ? x[i] : neg_inf;
        idx[pos] = col < a ? col : a + pos;
      }
    }
  } else {
    // 4. select: T = key of the k-th largest live entry, r = ties to take
    uint32_t t_key = kDeadKey;
    int r = 0;
    if (n_live > k) {
      uint32_t prefix = 0u, pmask = 0u;
      r = k;
      for (int shift = 24; shift >= 0; shift -= 8) {
#pragma unroll
        for (int i = 0; i < kMaxIters; ++i) {
          const bool live = x[i] > thresh;
          const uint32_t kx = order_key(x[i]);
          const bool part = live && (kx & pmask) == prefix;
          const uint32_t digit = (kx >> shift) & 0xffu;
          const unsigned peers = __match_any_sync(kFull, part ? digit : ~0u);
          if (part && __ffs(peers) - 1 == lane) {
            atomicAdd(&s_hist[warp][digit], static_cast<unsigned>(
                __popc(peers)));
          }
        }
        __syncthreads();
        // suffix scan over the bins, highest digit first
        const int d = 255 - static_cast<int>(threadIdx.x);
        int c = 0;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) c += s_hist[w][d];
        int incl = c;
        for (int off = 1; off < 32; off <<= 1) {
          const int v = __shfl_up_sync(kFull, incl, off);
          if (lane >= off) incl += v;
        }
        if (lane == 31) s_scan[warp] = incl;
        __syncthreads();
        for (int w = 0; w < warp; ++w) incl += s_scan[w];
        if (incl >= r && incl - c < r) {
          s_digit = d;
          s_rank = r - (incl - c);
        }
        for (int dd = lane; dd < 256; dd += 32) s_hist[warp][dd] = 0u;
        __syncthreads();
        prefix |= static_cast<uint32_t>(s_digit) << shift;
        pmask |= 0xffu << shift;
        r = s_rank;
      }
      t_key = prefix;
    }

    // the tie cut, in index order: per-warp counts, then ranks by ballot
    int gt = 0, eq = 0;
#pragma unroll
    for (int i = 0; i < kMaxIters; ++i) {
      const bool live = x[i] > thresh;
      const uint32_t kx = order_key(x[i]);
      gt += __popc(__ballot_sync(kFull, live && kx > t_key));
      eq += __popc(__ballot_sync(kFull, live && kx == t_key));
    }
    if (lane == 0) {
      s_warp_a[warp] = gt;
      s_warp_b[warp] = eq;
    }
    __syncthreads();
    int eq_before = 0, pos0 = 0;
    for (int w = 0; w < warp; ++w) {
      pos0 += s_warp_a[w] + min(max(r - eq_before, 0), s_warp_b[w]);
      eq_before += s_warp_b[w];
    }
#pragma unroll
    for (int i = 0; i < kMaxIters; ++i) {
      const bool live = x[i] > thresh;
      const uint32_t kx = order_key(x[i]);
      const unsigned gtb = __ballot_sync(kFull, live && kx > t_key);
      const unsigned eqb = __ballot_sync(kFull, live && kx == t_key);
      const bool take = ((gtb >> lane) & 1u) ||
                        (((eqb >> lane) & 1u) &&
                         eq_before + __popc(eqb & lower) < r);
      const unsigned takeb = __ballot_sync(kFull, take);
      if (take) {
        const int pos = pos0 + __popc(takeb & lower);
        key[pos] = x[i];
        idx[pos] = col0 + i * 32;
      }
      pos0 += __popc(takeb);
      eq_before += __popc(eqb);
    }
    count = min(n_live, k);
    width = next_pow2_dev(count);
  }
  // padding past every real index, then sort and write the first k
  for (int t = count + threadIdx.x; t < width; t += kThreads) {
    key[t] = neg_inf;
    idx[t] = a + t;
  }
  __syncthreads();
  bitonic_sort(key, idx, width);
  for (int j = threadIdx.x; j < k; j += kThreads) {
    const float v = j < width ? key[j] : neg_inf;
    const bool live = v > thresh;
    osc[j] = live ? v : neg_inf;
    oidx[j] = live ? idx[j] : 0;
  }
}

int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

}  // namespace

// scores: (p, a) f32; out_sc: (p, k) f32; out_idx: (p, k) int32. All
// contiguous on the current device; stream is a cudaStream_t. The caller
// guarantees 1 <= k <= min(a, slots * 128) and a <= 4,096. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int topk_sparse(const void* scores, void* out_sc, void* out_idx,
                           int p, int a, int k, float thresh, int slots,
                           void* stream) {
  if (p == 0 || k == 0) return 0;
  const int chunks = (a + kChunk - 1) / kChunk;
  if (chunks > kMaxChunks || k > a || slots < 1 || k > slots * kChunk) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // whole chunks per warp, so a chunk's ballots stay inside one warp
  const int warp_span = (chunks + kWarps - 1) / kWarps * kChunk;
  const int buffer = next_pow2(
      (slots < chunks ? slots : chunks) * kChunk > k
          ? (slots < chunks ? slots : chunks) * kChunk
          : k);
  const size_t smem = static_cast<size_t>(buffer) * 2 * sizeof(float);
  topk_sparse_kernel<<<p, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scores), static_cast<float*>(out_sc),
      static_cast<int*>(out_idx), a, k, thresh, slots, warp_span);
  return static_cast<int>(cudaGetLastError());
}
