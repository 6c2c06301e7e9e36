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
//      - Passes of 8-bit digits, most significant first, over the
//        registers. Each warp counts into its own 256-bin histogram in
//        shared memory, one atomic per live entry (on an H100 faster than
//        one per distinct digit of the 32 lanes by __match_any_sync: 1.47
//        against 1.74 ms for a b128 ssd300 batch). A suffix scan over the
//        256 bins picks the digit, the rank left inside it and the entries
//        in it. Where the row's live keys share their top bits (the long-
//        row and class-tile launches find the largest and smallest in
//        their first sweep), the passes start below them; once the chosen
//        bin's entries fit in the sort buffer, their keys are copied there
//        and the passes left count over that copy alone.
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
// buffer an entry landed. Where the k-th key's entries are all kept (r is
// their count, which the select's last pass leaves), the index order is
// not needed: one visit places the kept entries by atomics.
//
// Rows over 4,096 (ssd300: A = 8,732, ssd512: 24,732) take a second launch
// shape, topk_sparse_long, with the same branches; the radix select, the
// tie cut and the sort-and-write are one set of device functions that all
// launch shapes call, each with its own visitor over a thread's scores
// (registers in one, re-reads of the live chunks in the others). A
// row of 35-99 KB does not fit in registers, so the block reads it from
// device memory in sweeps (sweep_row). Warp w owns the contiguous chunks
// [w * span, (w + 1) * span) (span = ceil(chunks / 8)) and walks them in
// ascending order, so the per-warp prefix of the tie cut still counts in
// index order:
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
//
// The class-tile launch, topk_sparse_classes, reads the postprocess's
// softmax output (B, A, C) in its own layout: the rows are the foreground
// classes 1 ... C-1 of each image, a row's entries C floats apart (364 B
// at C = 91). Copying the transposed scores contiguous first cost more
// than the select (2.35 of 10.49 ms a b128 ssd300 request, with the sort
// it fed). Bound: bytes, the (B, A, C) scores read once (406.9 MB at b128
// on ssd300) and 8 bytes a slot written.
//   - One block per (image, tile of `tile` consecutive classes) copies
//     its (A x tile) sub-slab into shared memory once, row by row: 4 *
//     tile contiguous bytes an anchor, the neighbouring tiles' classes in
//     the same 32-byte sectors, met again in L2. TMA cannot fetch it: the
//     pitch, 364 B, is no multiple of 16 B. Each thread puts ~35 4-byte
//     cp.async copies in flight before it waits, so the block's whole
//     slab is in flight at once without a register per copy.
//   - Then every row runs sweep_row from shared memory: the same branches
//     and helpers as the long-row launch, its radix passes and tie pass
//     re-reading shared memory, never L2 or device memory.
//   - One block takes most of an SM's shared memory, so the rows are run
//     by up to 4 warp groups of 256 threads at once, each with its own
//     histograms and sort buffer (16.9 KB at k <= 1,024) and barrier
//     (bar.sync 1-4), so one group's barriers and sort stages overlap
//     another's: 32 warps an SM where one row per block would leave 8.
//   - The plan (topk_classes_plan) adapts to what the launch observes: the
//     most groups, then the most rows, that fit in the shared memory a
//     block may take. On an H100 (227 KB): A = 3,234 (ssdlite320) 4
//     groups x 12 rows; A = 8,732 (ssd300) 4 x 4; A = 24,732 (ssd512)
//     1 x 2. The last tile of an image may be partial. No row fits above
//     ~53,800 scores: those rows take the long-row launch over a
//     contiguous copy.

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
// warp groups of the class-tile launch: a block of at most 1,024 threads
constexpr int kMaxGroups = 4;

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

// The kThreads threads that work one row together: the whole block in the
// register and long-row launches, one warp group of the class-tile launch.
// tid is the thread's index in the group, bar the barrier the group waits
// at (0, the block's own, where the group is the block).
struct Group {
  int tid;
  int bar;
  __device__ __forceinline__ int lane() const { return tid & 31; }
  __device__ __forceinline__ int warp() const { return tid >> 5; }
  __device__ __forceinline__ void sync() const {
    asm volatile("bar.sync %0, %1;" ::"r"(bar), "n"(kThreads) : "memory");
  }
};

// One stage of the bitonic network on an entry held in a register: the
// entry (k, i) at position pos against its partner at pos ^ stride, which
// lane ^ stride of the same warp holds in the same register (stride < 32).
// The lower position of a pair keeps the entry that comes first where the
// block of `size` sorts descending ((pos & size) == 0), the upper the other.
__device__ __forceinline__ void lane_stage(float& k, int& i, int pos,
                                           int stride, int size) {
  const float pk = __shfl_xor_sync(kFull, k, stride);
  const int pi = __shfl_xor_sync(kFull, i, stride);
  const bool lower = (pos & stride) == 0;
  const bool desc = (pos & size) == 0;
  if ((lower == desc) == before(pk, pi, k, i)) {
    k = pk;
    i = pi;
  }
}

// The stages of sizes [from, to] whose stride is below 64, on each 64-entry
// segment of the n in shared memory, in registers: warp w holds segments w,
// w + kWarps, ..., two entries a lane (pos and pos + 32).
__device__ __forceinline__ void segment_stages(float* key, int* idx, int n,
                                               int from, int to,
                                               const Group& g) {
  for (int seg = g.warp(); seg < n / 64; seg += kWarps) {
    const int p0 = seg * 64 + g.lane();
    float k0 = key[p0], k1 = key[p0 + 32];
    int i0 = idx[p0], i1 = idx[p0 + 32];
    for (int size = from; size <= to; size <<= 1) {
      for (int stride = min(size >> 1, 32); stride > 0; stride >>= 1) {
        if (stride == 32) {
          if (before(k1, i1, k0, i0) == ((p0 & size) == 0)) {
            const float kt = k0;
            const int it = i0;
            k0 = k1;
            i0 = i1;
            k1 = kt;
            i1 = it;
          }
        } else {
          lane_stage(k0, i0, p0, stride, size);
          lane_stage(k1, i1, p0 + 32, stride, size);
        }
      }
    }
    key[p0] = k0;
    key[p0 + 32] = k1;
    idx[p0] = i0;
    idx[p0 + 32] = i1;
  }
}

// Sort n (a power of two) pairs in shared memory: key descending, index
// ascending on equal keys; the pairs are distinct. The bitonic network,
// its stages of stride 64 or more through shared memory, one barrier
// each, the others inside 64-entry segments in registers (10 barriers for
// n = 512, where one a stage took 45). Ends with a barrier.
__device__ void bitonic_sort(float* key, int* idx, int n, const Group& g) {
  const auto smem_stage = [&](int size, int stride) {
    for (int t = g.tid; t < n / 2; t += kThreads) {
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
    g.sync();
  };
  if (n < 64) {
    for (int size = 2; size <= n; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        smem_stage(size, stride);
      }
    }
    return;
  }
  segment_stages(key, idx, n, 2, 64, g);
  g.sync();
  for (int size = 128; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride >= 64; stride >>= 1) {
      smem_stage(size, stride);
    }
    segment_stages(key, idx, n, size, size, g);
    g.sync();
  }
}

// The helpers below are shared by the three launch shapes. Each takes a
// visitor over the scores the calling thread owns: visit(f) calls f(x, col)
// for each of them, in ascending index order within its warp's range, and
// every lane of a warp makes the same calls (x = -inf where there is no
// score), so f may vote. Every thread of the group calls each helper.

// All k output slots as padding.
__device__ __forceinline__ void write_padding(float* osc, int* oidx, int k,
                                              const Group& g) {
  for (int j = g.tid; j < k; j += kThreads) {
    osc[j] = -CUDART_INF_F;
    oidx[j] = 0;
  }
}

// The radix select: returns the key T of the k-th largest live score the
// visitor yields, in *r_out the number of entries equal to T among the top
// k and in *ties_out the number of live entries equal to T. Needs more than
// k of the n_live live scores, every live key in [lo, hi] (0 and
// 0xffffffff where the caller has no bounds).
//   - The bits above the highest one where lo and hi differ are the
//     prefix of every live key: the passes start below them (3 passes
//     where a softmax row's scores share sign and exponent, 4 with no
//     bounds), 8 bits a pass, fewer in the last; lo == hi is all ties.
//   - Each warp counts into its own histogram row (zeroed by the caller
//     before the first barrier, zeroed again here after each pass), one
//     shared-memory atomic per live entry of the prefix; a suffix scan
//     over the 256 bins picks the digit, the rank left inside it and the
//     entries in it.
//   - Once those entries fit in `cap` (the sort buffer, free until the tie
//     cut), one more visit copies their keys into `cand`, and the passes
//     left count over the copy alone, not the row.
// s_vars: 4 shared ints (the digit, rank and count of a pass; the copy's
// length).
template <class Visit>
__device__ __forceinline__ uint32_t radix_select(
    const Visit& visit, float thresh, int k, int n_live, uint32_t lo,
    uint32_t hi, int* r_out, int* ties_out, unsigned (*hist)[256], int* scan,
    int* s_vars, uint32_t* cand, int cap, const Group& g) {
  if (lo == hi) {
    *r_out = k;
    *ties_out = n_live;
    return lo;
  }
  const int lane = g.lane();
  const int warp = g.warp();
  const unsigned lower = (1u << lane) - 1u;
  const int top = 31 - __clz(lo ^ hi);  // highest bit where they differ
  uint32_t pmask = ~((2u << top) - 1u);
  uint32_t prefix = hi & pmask;
  int r = k;
  int n_cand = -1;  // entries copied into cand, -1 before the copy
  for (int low = top - 7;; low -= 8) {
    const int shift = max(low, 0);
    const uint32_t dmask = (1u << (low >= 0 ? 8 : 8 + low)) - 1u;
    if (n_cand < 0) {
      visit([&](float x, int) {
        const uint32_t kx = order_key(x);
        if (x > thresh && (kx & pmask) == prefix) {
          atomicAdd(&hist[warp][(kx >> shift) & dmask], 1u);
        }
      });
    } else {
      for (int i = g.tid; i < n_cand; i += kThreads) {
        const uint32_t kx = cand[i];
        if ((kx & pmask) == prefix) {
          atomicAdd(&hist[warp][(kx >> shift) & dmask], 1u);
        }
      }
    }
    g.sync();
    // suffix scan over the bins, highest digit first
    const int d = 255 - g.tid;
    int c = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) c += hist[w][d];
    int incl = c;
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += v;
    }
    if (lane == 31) scan[warp] = incl;
    g.sync();
    for (int w = 0; w < warp; ++w) incl += scan[w];
    if (incl >= r && incl - c < r) {
      s_vars[0] = d;
      s_vars[1] = r - (incl - c);
      s_vars[2] = c;
    }
    for (int dd = lane; dd < 256; dd += 32) hist[warp][dd] = 0u;
    if (g.tid == 0) s_vars[3] = 0;
    g.sync();
    prefix |= static_cast<uint32_t>(s_vars[0]) << shift;
    pmask |= dmask << shift;
    r = s_vars[1];
    if (shift == 0) {
      *ties_out = s_vars[2];
      break;
    }
    if (n_cand < 0 && s_vars[2] <= cap) {
      // the entries of the chosen bin, in any order: their keys alone
      visit([&](float x, int) {
        const uint32_t kx = order_key(x);
        const bool take = x > thresh && (kx & pmask) == prefix;
        const unsigned tb = __ballot_sync(kFull, take);
        if (tb != 0u) {
          const int first = __ffs(tb) - 1;
          int base = 0;
          if (lane == first) base = atomicAdd(&s_vars[3], __popc(tb));
          base = __shfl_sync(kFull, base, first);
          if (take) cand[base + __popc(tb & lower)] = kx;
        }
      });
      g.sync();
      n_cand = s_vars[3];
    }
  }
  *r_out = r;
  return prefix;
}

// The tie cut: every live entry with key > t_key and the first r in index
// order with key == t_key go to key/idx (every live entry when t_key is the
// key of -inf and r is 0). Where r is all `ties` entries equal to t_key
// (the k-th key is not shared past the cut, as a row of distinct scores
// has it), one visit takes every live entry at or above t_key, each warp's
// share placed by one atomic: the sort that follows fixes the order.
// Otherwise in index order: per-warp counts, a prefix over the warps, then
// ranks by ballot inside the warp.
template <class Visit>
__device__ __forceinline__ void tie_cut(const Visit& visit, float thresh,
                                        uint32_t t_key, int r, int ties,
                                        float* key, int* idx, int* warp_gt,
                                        int* warp_eq, const Group& g) {
  const int lane = g.lane();
  const int warp = g.warp();
  const unsigned lower = (1u << lane) - 1u;
  if (ties == r) {
    if (g.tid == 0) warp_gt[0] = 0;
    g.sync();
    visit([&](float x, int col) {
      const bool take = x > thresh && order_key(x) >= t_key;
      const unsigned tb = __ballot_sync(kFull, take);
      if (tb != 0u) {
        const int first = __ffs(tb) - 1;
        int base = 0;
        if (lane == first) base = atomicAdd(&warp_gt[0], __popc(tb));
        base = __shfl_sync(kFull, base, first);
        if (take) {
          key[base + __popc(tb & lower)] = x;
          idx[base + __popc(tb & lower)] = col;
        }
      }
    });
    return;
  }
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
  g.sync();
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
                                               int* oidx, const Group& g) {
  for (int t = count + g.tid; t < width; t += kThreads) {
    key[t] = -CUDART_INF_F;
    idx[t] = a + t;
  }
  g.sync();
  bitonic_sort(key, idx, width, g);
  for (int j = g.tid; j < k; j += kThreads) {
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
  __shared__ int s_n_chunks, s_n_live;
  __shared__ int s_vars[4];

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
  const Group g{static_cast<int>(threadIdx.x), 0};

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
    write_padding(osc, oidx, k, g);
    return;
  }

  const int buffer = next_pow2_dev(max(min(slots, chunks) * kChunk, k));
  float* key = smem;
  int* idx = reinterpret_cast<int*>(smem) + buffer;
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
    int r = 0, ties = 0;
    if (n_live > k) {
      t_key = radix_select(visit, thresh, k, n_live, 0u, 0xffffffffu, &r,
                           &ties, s_hist, s_scan, s_vars,
                           reinterpret_cast<uint32_t*>(key), buffer, g);
    }
    tie_cut(visit, thresh, t_key, r, ties, key, idx, s_warp_a, s_warp_b, g);
    count = min(n_live, k);
    width = next_pow2_dev(count);
  }
  sort_and_write(key, idx, count, width, a, k, thresh, osc, oidx, g);
}

// Shared memory that one row's sweeps use: the select's histograms, its
// per-warp counts and scan, kScalars scalars (live chunks, live entries,
// the largest and smallest live key, radix_select's four), the live flag
// of each chunk, the chunk of each compact slot, and the sort buffer's
// keys and indices (`buffer` of each).
constexpr int kScalars = 8;

struct RowScratch {
  unsigned (*hist)[256];
  int* warp_a;
  int* warp_b;
  int* scan;
  int* scalars;
  int* live;
  int* slot_chunk;
  float* key;
  int* idx;
  int buffer;
};

// One row of any length through the sweeps of the note at the top, read
// from device memory (the long-row launch) or from shared memory (the
// class-tile launch). Warp w of the group owns the chunks [w * span,
// (w + 1) * span).
__device__ __forceinline__ void sweep_row(const float* row, float* osc,
                                          int* oidx, int a, int k,
                                          float thresh, int slots, int span,
                                          const Group& g,
                                          const RowScratch& s) {
  const float neg_inf = -CUDART_INF_F;
  const int chunks = (a + kChunk - 1) / kChunk;
  const int lane = g.lane();
  const int warp = g.warp();
  const unsigned lower = (1u << lane) - 1u;
  const int c_begin = min(warp * span, chunks);
  const int c_end = min(c_begin + span, chunks);

  // 1. sweep 1: live entries and live chunks by ballot, and the largest
  // and smallest live key
  int n_live = 0;
  uint32_t hi = 0u, lo = 0xffffffffu;
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
      const bool live = x[j] > thresh;
      const unsigned hit = __ballot_sync(kFull, live);
      n_live += __popc(hit);
      any |= hit;
      if (live) {
        hi = max(hi, order_key(x[j]));
        lo = min(lo, order_key(x[j]));
      }
    }
    if (lane == 0) s.live[c] = any != 0u;
  }
  hi = __reduce_max_sync(kFull, hi);
  lo = __reduce_min_sync(kFull, lo);
  for (int d = lane; d < 256; d += 32) s.hist[warp][d] = 0u;
  if (lane == 0) {
    s.warp_a[warp] = n_live;
    s.warp_b[warp] = static_cast<int>(hi);
    s.scan[warp] = static_cast<int>(lo);
  }
  g.sync();
  if (warp == 0) {
    int base = 0;
    for (int c0 = 0; c0 < chunks; c0 += 32) {
      const int c = c0 + lane;
      const bool live = c < chunks && s.live[c];
      const unsigned mask = __ballot_sync(kFull, live);
      const int slot = base + __popc(mask & lower);
      if (live && slot < slots) s.slot_chunk[slot] = c;
      base += __popc(mask);
    }
    int total = lane < kWarps ? s.warp_a[lane] : 0;
    for (int off = 16; off > 0; off >>= 1) {
      total += __shfl_xor_sync(kFull, total, off);
    }
    hi = __reduce_max_sync(
        kFull, lane < kWarps ? static_cast<uint32_t>(s.warp_b[lane]) : 0u);
    lo = __reduce_min_sync(kFull, lane < kWarps
                                      ? static_cast<uint32_t>(s.scan[lane])
                                      : 0xffffffffu);
    if (lane == 0) {
      s.scalars[0] = base;
      s.scalars[1] = total;
      s.scalars[2] = static_cast<int>(hi);
      s.scalars[3] = static_cast<int>(lo);
    }
  }
  g.sync();
  const int n_chunks = s.scalars[0];
  n_live = s.scalars[1];
  hi = static_cast<uint32_t>(s.scalars[2]);
  lo = static_cast<uint32_t>(s.scalars[3]);

  // 2. nothing above thresh: all padding
  if (n_chunks == 0) {
    write_padding(osc, oidx, k, g);
    return;
  }

  int count, width;
  if (n_chunks <= slots) {
    // 3. compact: the live chunks, read again, dead entries and all, in
    // slot order
    count = n_chunks * kChunk;
    width = next_pow2_dev(count);
    for (int t = g.tid; t < count; t += kThreads) {
      const int col = s.slot_chunk[t / kChunk] * kChunk + t % kChunk;
      const float v = col < a ? row[col] : neg_inf;
      s.key[t] = v > thresh ? v : neg_inf;
      s.idx[t] = col < a ? col : a + t;
    }
  } else {
    // 4. select: each pass re-reads only the warp's live chunks (a dead
    // chunk holds nothing the select counts)
    const auto visit = [&](auto f) {
      for (int c = c_begin; c < c_end; ++c) {
        if (!s.live[c]) continue;
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
    int r = 0, ties = 0;
    if (n_live > k) {
      t_key = radix_select(visit, thresh, k, n_live, lo, hi, &r, &ties,
                           s.hist, s.scan, s.scalars + 4,
                           reinterpret_cast<uint32_t*>(s.key), s.buffer, g);
    }
    tie_cut(visit, thresh, t_key, r, ties, s.key, s.idx, s.warp_a, s.warp_b,
            g);
    count = min(n_live, k);
    width = next_pow2_dev(count);
  }
  sort_and_write(s.key, s.idx, count, width, a, k, thresh, osc, oidx, g);
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
  __shared__ int s_scalars[kScalars];

  const int chunks = (a + kChunk - 1) / kChunk;
  const RowScratch s{s_hist,
                     s_warp_a,
                     s_warp_b,
                     s_scan,
                     s_scalars,
                     lsmem,
                     lsmem + chunks,
                     reinterpret_cast<float*>(lsmem + chunks + slots),
                     lsmem + chunks + slots + buffer,
                     buffer};
  const int64_t row = blockIdx.x;
  sweep_row(scores + row * a, out_sc + row * k, out_idx + row * k, a, k,
            thresh, slots, span, Group{static_cast<int>(threadIdx.x), 0}, s);
}

// One 4-byte copy from device to shared memory, in flight until
// cp_async_wait_all: no register holds it.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Ints of the shared scratch of one warp group of the class-tile launch:
// a RowScratch, laid out as its fields are listed.
constexpr int kScratchFixed = kWarps * 256 + 3 * kWarps + kScalars;

// The class-tile launch (see the note at the top). Block b holds rows
// [r0, r0 + tile) of image b / tiles, each row's scores in shared memory
// at its own offset; each warp group runs rows group, group + groups, ...
// of them through sweep_row with a RowScratch of its own after the tile's
// scratch. Dynamic shared memory: tile * a floats, then groups * words
// ints.
__global__ void __launch_bounds__(kMaxGroups * kThreads)
topk_sparse_classes_kernel(const float* __restrict__ scores,
                           float* __restrict__ out_sc,
                           int* __restrict__ out_idx, int rows, int a,
                           int64_t pitch, int64_t batch_stride, int k,
                           float thresh, int slots, int span, int buffer,
                           int tile, int groups, int tiles, int words) {
  extern __shared__ int csmem[];
  const int image = blockIdx.x / tiles;
  const int r0 = (blockIdx.x - image * tiles) * tile;
  const int tn = min(tile, rows - r0);
  float* held = reinterpret_cast<float*>(csmem);

  // the sub-slab (A x tn) in one sweep of 4-byte copies, all in flight
  // together: element e is anchor e / tn, row e % tn, so a warp reads
  // ~32 / tn anchors' neighbouring classes
  const float* src = scores + image * batch_stride + r0;
  const int n = a * tn;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int anchor = e / tn;
    const int r = e - anchor * tn;
    cp_async4(held + r * a + anchor, src + anchor * pitch + r);
  }
  cp_async_wait_all();
  __syncthreads();

  const int gi = threadIdx.x / kThreads;
  const int chunks = (a + kChunk - 1) / kChunk;
  int* gs = csmem + tile * a + gi * words;
  const RowScratch s{reinterpret_cast<unsigned(*)[256]>(gs),
                     gs + kWarps * 256,
                     gs + kWarps * 256 + kWarps,
                     gs + kWarps * 256 + 2 * kWarps,
                     gs + kWarps * 256 + 3 * kWarps,
                     gs + kScratchFixed,
                     gs + kScratchFixed + chunks,
                     reinterpret_cast<float*>(gs + kScratchFixed + chunks +
                                              slots),
                     gs + kScratchFixed + chunks + slots + buffer,
                     buffer};
  const Group g{static_cast<int>(threadIdx.x) - gi * kThreads, 1 + gi};
  for (int r = gi; r < tn; r += groups) {
    const int64_t out_row = static_cast<int64_t>(image) * rows + r0 + r;
    sweep_row(held + r * a, out_sc + out_row * k, out_idx + out_row * k, a,
              k, thresh, slots, span, g, s);
  }
}

int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// Sizes shared by the long-row and class-tile launches.
struct Sweep {
  int chunks;  // 128-wide chunks of a row
  int span;    // chunks a warp owns
  int buffer;  // entries of the sort buffer
};

Sweep sweep_sizes(int a, int k, int slots) {
  const int chunks = (a + kChunk - 1) / kChunk;
  const int held = (slots < chunks ? slots : chunks) * kChunk;
  return {chunks, (chunks + kWarps - 1) / kWarps,
          next_pow2(held > k ? held : k)};
}

int scratch_words(const Sweep& sw, int slots) {
  return kScratchFixed + sw.chunks + slots + 2 * sw.buffer;
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
  const Sweep sw = sweep_sizes(a, k, slots);
  const size_t smem = (static_cast<size_t>(sw.chunks) + slots) * sizeof(int) +
                      static_cast<size_t>(sw.buffer) * 2 * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        topk_sparse_long_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  topk_sparse_long_kernel<<<p, kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scores), static_cast<float*>(out_sc),
      static_cast<int*>(out_idx), a, k, thresh, slots, sw.span, sw.buffer);
  return static_cast<int>(cudaGetLastError());
}

// The class-tile launch's plan for `rows` rows of `a` scores at k and
// slots, on the current device: *groups warp groups (at most 4), each
// with a scratch of its own, and *tile rows a block holds, the most that
// fit beside them in the shared memory a block may take (the device's
// opt-in limit, 227 KB on an H100); the most groups that still get a row
// each. *smem_bytes: the block's dynamic shared memory. *tile is 0 where
// not one row fits (a above ~53,800 on an H100): the caller takes the
// long-row launch over a contiguous copy. Returns a CUDA error code (0 on
// success).
extern "C" int topk_classes_plan(int a, int k, int slots, int rows,
                                 int* tile, int* groups,
                                 long long* smem_bytes) {
  *tile = 0;
  *groups = 0;
  *smem_bytes = 0;
  int dev = 0, cap = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&cap, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long row = 4LL * a;
  const long long scratch = 4LL * scratch_words(sweep_sizes(a, k, slots),
                                                slots);
  for (int g = kMaxGroups; g >= 1; --g) {
    long long t = cap >= g * scratch ? (cap - g * scratch) / row : 0;
    if (t > rows) t = rows;
    if (t >= g) {
      *tile = static_cast<int>(t);
      *groups = g;
      *smem_bytes = t * row + g * scratch;
      return 0;
    }
  }
  return 0;
}

// The class-major layout of the softmax output: scores (b, rows, a) f32 on
// the current device, row r of image i at scores + i * batch_stride + r,
// its entries pitch apart (the view scores[..., 1:].transpose(1, 2) of a
// contiguous (b, a, c) tensor: pitch c, batch_stride a * c). out_sc
// (b, rows, k) f32 and out_idx (b, rows, k) int32, contiguous: the
// contract of topk_sparse for each (image, row). The caller guarantees
// 1 <= k <= min(a, slots * 128). Returns cudaErrorInvalidValue where no
// row fits (topk_classes_plan's tile 0), else cudaGetLastError() after
// the launch, or the error of the plan or of raising the kernel's
// shared-memory limit.
extern "C" int topk_sparse_classes(const void* scores, void* out_sc,
                                   void* out_idx, int b, int rows, int a,
                                   long long pitch, long long batch_stride,
                                   int k, float thresh, int slots,
                                   void* stream) {
  if (b == 0 || rows == 0 || k == 0) return 0;
  if (k > a || slots < 1 || k > slots * kChunk) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int tile = 0, groups = 0;
  long long smem = 0;
  int code = topk_classes_plan(a, k, slots, rows, &tile, &groups, &smem);
  if (code != 0) return code;
  if (tile == 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      topk_sparse_classes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const Sweep sw = sweep_sizes(a, k, slots);
  const int tiles = (rows + tile - 1) / tile;
  topk_sparse_classes_kernel<<<b * tiles, groups * kThreads,
                               static_cast<size_t>(smem),
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scores), static_cast<float*>(out_sc),
      static_cast<int*>(out_idx), rows, a, pitch, batch_stride, k, thresh,
      slots, sw.span, sw.buffer, tile, groups, tiles,
      scratch_words(sw, slots));
  return static_cast<int>(cudaGetLastError());
}
