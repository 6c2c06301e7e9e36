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
//
// Rows over 4,096 (ssd300: A = 8,732, ssd512: 24,732) take a second launch
// shape, topk_sparse_long, with the same branches; the radix select, the
// tie cut and the sort-and-write are one set of device functions that both
// launch shapes call, each with its own visitor over a thread's scores
// (registers in one, re-reads of the live chunks in the other). A
// row of 35-99 KB does not fit in registers, so the block reads it from
// device memory in sweeps. Warp w owns the contiguous chunks [w * span,
// (w + 1) * span) (span = ceil(chunks / 8)) and walks them in ascending
// order, so the per-warp prefix of the tie cut still counts in index
// order:
//   1. Sweep 1 reads the row once: per chunk, four ballots OR-ed into one
//      live flag, kept in dynamic shared memory (one int per chunk, 194 at
//      A = 24,732: no practical row limit); warp 0 scans the flags 32 at a
//      time to give each live chunk its slot.
//   2. No live chunk: padding.
//   3. Compact: only the live chunks are read again, in slot order.
//   4. Select: each radix pass and the tie pass re-read only the live
//      chunks (a dead chunk holds nothing the select counts), from L2
//      while the block runs. The tail past the last full chunk (A % 128,
//      28 scores at both VGG sizes) reads as -inf and is never read past
//      the row.

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

// The helpers below are shared by both launch shapes. Each takes a
// visitor over the scores the calling thread owns: visit(f) calls f(x, col)
// for each of them, in ascending index order within its warp's range, and
// every lane of a warp makes the same calls (x = -inf where there is no
// score), so f may vote. Every thread of the block calls each helper.

// All k output slots as padding.
__device__ __forceinline__ void write_padding(float* osc, int* oidx, int k) {
  for (int j = threadIdx.x; j < k; j += kThreads) {
    osc[j] = -CUDART_INF_F;
    oidx[j] = 0;
  }
}

// The radix select: returns the key T of the k-th largest live score the
// visitor yields, and in *r_out the number of entries equal to T among the
// top k. Needs more than k live scores. Four passes of 8-bit digits, most
// significant first; each warp counts into its own histogram row (zeroed by
// the caller before the first barrier, zeroed again here after each pass),
// one atomic per distinct digit of the 32 lanes; a suffix scan over the 256
// bins picks the digit and the rank left inside it.
template <class Visit>
__device__ __forceinline__ uint32_t radix_select(
    const Visit& visit, float thresh, int k, int* r_out,
    unsigned (*hist)[256], int* scan, int* s_digit, int* s_rank) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint32_t prefix = 0u, pmask = 0u;
  int r = k;
  for (int shift = 24; shift >= 0; shift -= 8) {
    visit([&](float x, int) {
      const bool live = x > thresh;
      const uint32_t kx = order_key(x);
      const bool part = live && (kx & pmask) == prefix;
      const uint32_t digit = (kx >> shift) & 0xffu;
      const unsigned peers = __match_any_sync(kFull, part ? digit : ~0u);
      if (part && __ffs(peers) - 1 == lane) {
        atomicAdd(&hist[warp][digit], static_cast<unsigned>(__popc(peers)));
      }
    });
    __syncthreads();
    // suffix scan over the bins, highest digit first
    const int d = 255 - static_cast<int>(threadIdx.x);
    int c = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) c += hist[w][d];
    int incl = c;
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += v;
    }
    if (lane == 31) scan[warp] = incl;
    __syncthreads();
    for (int w = 0; w < warp; ++w) incl += scan[w];
    if (incl >= r && incl - c < r) {
      *s_digit = d;
      *s_rank = r - (incl - c);
    }
    for (int dd = lane; dd < 256; dd += 32) hist[warp][dd] = 0u;
    __syncthreads();
    prefix |= static_cast<uint32_t>(*s_digit) << shift;
    pmask |= 0xffu << shift;
    r = *s_rank;
  }
  *r_out = r;
  return prefix;
}

// The tie cut, in index order: every live entry with key > t_key and the
// first r with key == t_key go to key/idx, in index order (every live entry
// when t_key is the key of -inf and r is 0). Per-warp counts, a prefix over
// the warps, then ranks by ballot inside the warp.
template <class Visit>
__device__ __forceinline__ void tie_cut(const Visit& visit, float thresh,
                                        uint32_t t_key, int r, float* key,
                                        int* idx, int* warp_gt, int* warp_eq) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lower = (1u << lane) - 1u;
  int gt = 0, eq = 0;
  visit([&](float x, int) {
    const bool live = x > thresh;
    const uint32_t kx = order_key(x);
    gt += __popc(__ballot_sync(kFull, live && kx > t_key));
    eq += __popc(__ballot_sync(kFull, live && kx == t_key));
  });
  if (lane == 0) {
    warp_gt[warp] = gt;
    warp_eq[warp] = eq;
  }
  __syncthreads();
  int eq_before = 0, pos0 = 0;
  for (int w = 0; w < warp; ++w) {
    pos0 += warp_gt[w] + min(max(r - eq_before, 0), warp_eq[w]);
    eq_before += warp_eq[w];
  }
  visit([&](float x, int col) {
    const bool live = x > thresh;
    const uint32_t kx = order_key(x);
    const unsigned gtb = __ballot_sync(kFull, live && kx > t_key);
    const unsigned eqb = __ballot_sync(kFull, live && kx == t_key);
    const bool take = ((gtb >> lane) & 1u) ||
                      (((eqb >> lane) & 1u) &&
                       eq_before + __popc(eqb & lower) < r);
    const unsigned takeb = __ballot_sync(kFull, take);
    if (take) {
      const int pos = pos0 + __popc(takeb & lower);
      key[pos] = x;
      idx[pos] = col;
    }
    pos0 += __popc(takeb);
    eq_before += __popc(eqb);
  });
}

// The buffer's first `count` entries padded to `width` (a power of two)
// with indices past every real one, sorted, and the first k written out,
// dead entries as padding.
__device__ __forceinline__ void sort_and_write(float* key, int* idx, int count,
                                               int width, int a, int k,
                                               float thresh, float* osc,
                                               int* oidx) {
  for (int t = count + threadIdx.x; t < width; t += kThreads) {
    key[t] = -CUDART_INF_F;
    idx[t] = a + t;
  }
  __syncthreads();
  bitonic_sort(key, idx, width);
  for (int j = threadIdx.x; j < k; j += kThreads) {
    const float v = j < width ? key[j] : -CUDART_INF_F;
    const bool live = v > thresh;
    osc[j] = live ? v : -CUDART_INF_F;
    oidx[j] = live ? idx[j] : 0;
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
    write_padding(osc, oidx, k);
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
    // 4. select: T = key of the k-th largest live entry, r = ties to take;
    // every register, dead ones included, is visited
    const auto visit = [&](auto f) {
#pragma unroll
      for (int i = 0; i < kMaxIters; ++i) f(x[i], col0 + i * 32);
    };
    uint32_t t_key = kDeadKey;
    int r = 0;
    if (n_live > k) {
      t_key = radix_select(visit, thresh, k, &r, s_hist, s_scan, &s_digit,
                           &s_rank);
    }
    tie_cut(visit, thresh, t_key, r, key, idx, s_warp_a, s_warp_b);
    count = min(n_live, k);
    width = next_pow2_dev(count);
  }
  sort_and_write(key, idx, count, width, a, k, thresh, osc, oidx);
}

// Rows of any length, read from device memory in sweeps (see the note at
// the top). Dynamic shared memory: the live flag of each chunk (int), the
// chunk of each compact slot (int), then the sort buffer's keys and
// indices.
__global__ void __launch_bounds__(kThreads)
topk_sparse_long_kernel(const float* __restrict__ scores,
                        float* __restrict__ out_sc, int* __restrict__ out_idx,
                        int a, int k, float thresh, int slots, int span,
                        int buffer) {
  extern __shared__ int lsmem[];
  __shared__ unsigned s_hist[kWarps][256];
  __shared__ int s_warp_a[kWarps];
  __shared__ int s_warp_b[kWarps];
  __shared__ int s_scan[kWarps];
  __shared__ int s_n_chunks, s_n_live, s_digit, s_rank;

  const float neg_inf = -CUDART_INF_F;
  const int chunks = (a + kChunk - 1) / kChunk;
  int* s_live = lsmem;
  int* s_slot_chunk = lsmem + chunks;
  float* key = reinterpret_cast<float*>(lsmem + chunks + slots);
  int* idx = lsmem + chunks + slots + buffer;
  const float* row = scores + static_cast<int64_t>(blockIdx.x) * a;
  float* osc = out_sc + static_cast<int64_t>(blockIdx.x) * k;
  int* oidx = out_idx + static_cast<int64_t>(blockIdx.x) * k;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lower = (1u << lane) - 1u;
  const int c_begin = min(warp * span, chunks);
  const int c_end = min(c_begin + span, chunks);

  // 1. sweep 1: live entries and live chunks by ballot
  int n_live = 0;
  for (int c = c_begin; c < c_end; ++c) {
    float x[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = c * kChunk + j * 32 + lane;
      x[j] = col < a ? row[col] : neg_inf;
    }
    unsigned any = 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const unsigned hit = __ballot_sync(kFull, x[j] > thresh);
      n_live += __popc(hit);
      any |= hit;
    }
    if (lane == 0) s_live[c] = any != 0u;
  }
  for (int d = lane; d < 256; d += 32) s_hist[warp][d] = 0u;
  if (lane == 0) s_warp_a[warp] = n_live;
  __syncthreads();
  if (warp == 0) {
    int base = 0;
    for (int c0 = 0; c0 < chunks; c0 += 32) {
      const int c = c0 + lane;
      const bool live = c < chunks && s_live[c];
      const unsigned mask = __ballot_sync(kFull, live);
      const int slot = base + __popc(mask & lower);
      if (live && slot < slots) s_slot_chunk[slot] = c;
      base += __popc(mask);
    }
    int total = lane < kWarps ? s_warp_a[lane] : 0;
    for (int off = 16; off > 0; off >>= 1) {
      total += __shfl_xor_sync(kFull, total, off);
    }
    if (lane == 0) {
      s_n_chunks = base;
      s_n_live = total;
    }
  }
  __syncthreads();
  const int n_chunks = s_n_chunks;
  n_live = s_n_live;

  // 2. nothing above thresh: all padding
  if (n_chunks == 0) {
    write_padding(osc, oidx, k);
    return;
  }

  int count, width;
  if (n_chunks <= slots) {
    // 3. compact: the live chunks, read again, dead entries and all, in
    // slot order
    count = n_chunks * kChunk;
    width = next_pow2_dev(count);
    for (int t = threadIdx.x; t < count; t += kThreads) {
      const int col = s_slot_chunk[t / kChunk] * kChunk + t % kChunk;
      const float v = col < a ? row[col] : neg_inf;
      key[t] = v > thresh ? v : neg_inf;
      idx[t] = col < a ? col : a + t;
    }
  } else {
    // 4. select: each pass re-reads only the warp's live chunks (a dead
    // chunk holds nothing the select counts)
    const auto visit = [&](auto f) {
      for (int c = c_begin; c < c_end; ++c) {
        if (!s_live[c]) continue;
        float x[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = c * kChunk + j * 32 + lane;
          x[j] = col < a ? row[col] : neg_inf;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) f(x[j], c * kChunk + j * 32 + lane);
      }
    };
    uint32_t t_key = kDeadKey;
    int r = 0;
    if (n_live > k) {
      t_key = radix_select(visit, thresh, k, &r, s_hist, s_scan, &s_digit,
                           &s_rank);
    }
    tie_cut(visit, thresh, t_key, r, key, idx, s_warp_a, s_warp_b);
    count = min(n_live, k);
    width = next_pow2_dev(count);
  }
  sort_and_write(key, idx, count, width, a, k, thresh, osc, oidx);
}

int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

}  // namespace

// scores: (p, a) f32; out_sc: (p, k) f32; out_idx: (p, k) int32. All
// contiguous on the current device; stream is a cudaStream_t. The caller
// guarantees 1 <= k <= min(a, slots * 128) and a <= 4,096 (longer rows:
// topk_sparse_long). Returns cudaGetLastError() after the launch (0 on
// success).
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

// The same contract for rows of any length, read in sweeps (the long-row
// launch). The caller guarantees 1 <= k <= min(a, slots * 128). Returns
// cudaGetLastError() after the launch (0 on success), or the error of
// raising the kernel's shared-memory limit where it needs more than 48 KB.
extern "C" int topk_sparse_long(const void* scores, void* out_sc,
                                void* out_idx, int p, int a, int k,
                                float thresh, int slots, void* stream) {
  if (p == 0 || k == 0) return 0;
  if (k > a || slots < 1 || k > slots * kChunk) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int chunks = (a + kChunk - 1) / kChunk;
  const int span = (chunks + kWarps - 1) / kWarps;
  const int held = (slots < chunks ? slots : chunks) * kChunk;
  const int buffer = next_pow2(held > k ? held : k);
  const size_t smem = (static_cast<size_t>(chunks) + slots) * sizeof(int) +
                      static_cast<size_t>(buffer) * 2 * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        topk_sparse_long_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  topk_sparse_long_kernel<<<p, kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scores), static_cast<float*>(out_sc),
      static_cast<int*>(out_idx), a, k, thresh, slots, span, buffer);
  return static_cast<int>(cudaGetLastError());
}
