// Greedy NMS keep masks for P independent, score-sorted problems, by IoU
// bitmask and a serial sweep.
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
// chain: step i needs the suppression state left by steps < i. A block
// that walks the chain with a barrier and an IoU pass per kept candidate
// is latency-bound, and at the fused serving path's shapes (P = B problems
// of K = 1,024 or 2,048, one per image) only B such blocks exist, so most
// of the 132 SMs idle.
//
// Design: take the pairwise work off the chain. Bit (i, j) of a mask row
// is set when j > i and IoU(i, j) > threshold; a row is K/64 words of 64
// bits. The chain then needs only, for each i in order, one bit test and,
// when i is kept, an OR of its row into the "removed" bitset. Only the
// valid prefix is visited, and invalid candidates start out removed. Three
// launch shapes, chosen by the wrapper by K:
//   - block (K <= 512; the reference postprocess: P = B * 90 problems of
//     K = 300): one block of 4 warps per problem, the valid prefix's boxes
//     and areas and the removed bitset in shared memory. Per 64-candidate
//     tile, warp 0 walks the chain through the tile, computing the
//     diagonal word of each candidate it keeps and of no other; then the
//     4 warps compute the kept candidates' words against the later tiles,
//     a warp a word, OR-ed into the bitset with shared atomics. Columns
//     already removed are not tested, so the pairwise work is what the
//     greedy chain itself needs; two barriers per tile replace one per
//     kept candidate, and thousands of small blocks keep every SM busy.
//     Measured on the H100 against two alternatives: a block that builds
//     the whole mask in parallel first computes rows of candidates that
//     end up suppressed (slower than the kernel it replaces on dense
//     problems), and a warp per problem leaves a long problem's chain on
//     one warp (slower on a trained model, where one long problem sets
//     the time).
//   - tiled (512 < K <= 8,192; the fused path: P = B problems of K = 1,024
//     or 2,048): few problems, so a warp each would leave most SMs idle.
//     The whole mask goes to scratch in device memory, which the wrapper
//     allocates (16 MB at B = 32, K = 2,048). nms_mask_kernel builds it
//     with about 8 blocks an SM over the card: the blocks of a problem
//     share its tiles (64 rows, 64 columns on or above the diagonal)
//     inside the valid prefix. Words of invalid rows and past the prefix
//     are never written and never read. nms_sweep_kernel then sweeps each
//     problem with one warp: lane l keeps words l, l + 32, ... of the
//     removed bitset in registers; the owner lane's word of tile w is
//     broadcast once per tile (__shfl_sync) and every lane carries it
//     along, so a step is a bit test and a kept step a shared-memory OR.
//     All 4 warps stage the next tile's rows into shared memory with
//     cp.async (double-buffered) while warp 0 sweeps the current one, so
//     the chain does not wait on device memory.
//   - long (K > 8,192; the public NMS of one problem of N boxes): the
//     tiled launch's 128 removed words in registers and its full-width rows
//     in shared memory (2 x 64 rows x K / 64 words: 256 KB at K = 16,384)
//     no longer fit. The mask is built by the same nms_mask_kernel (K^2 / 8
//     bytes of scratch: 50 MB at K = 20,000). nms_sweep_long_kernel then
//     keeps the removed bitset, K / 64 words, in dynamic shared memory
//     (2.5 KB at 20,000) and walks the tiles in order, one block a
//     problem: it stages column piece w of tile w's 64 rows (the diagonal
//     words) in shared memory, warp 0 walks the chain through the tile on
//     them, and then the block ORs the kept rows' later column pieces into
//     the bitset, read from device memory, a thread a (row, word) with
//     shared atomics, so the loads of a tile are all in flight at once.
//     Three barriers a tile; a simple first version for a path that no
//     model runs.
// A word is one warp's work: lane l tests columns l and l + 32 and two
// ballots make the word, so no lane walks a loop of its own.
// A pair with no intersection is decided without the division: inter is
// exactly 0, so the IoU is 0 / max(u, 1e-9) = 0. Boxes of different
// classes in the fused path's class-offset problems never intersect, so
// most pairs take that path.
//
// Exactness: the IoU is written with __fsub_rn/__fmul_rn/__fadd_rn/
// __fdiv_rn in the reference's order, and the library is built with
// -fmad=false, so no FMA contraction rounds differently from the plain
// version at a decision that sits on the threshold. The decision is the
// strict `iou > iou_threshold` of the reference, and the shortcut for
// inter == 0 compares the same 0 with the threshold. The sweep visits the
// candidates in score order and ORs a row only for a candidate that is
// not removed when it is reached, which is the greedy algorithm.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

typedef unsigned long long u64;

constexpr int kTile = 64;            // candidates per mask word
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBlockThreads = 128;   // block path: 4 warps a problem
constexpr int kBlockMaxK = 512;      // block path: 8 mask words
constexpr int kMaskThreads = 128;    // tiled path's mask
constexpr int kSweepThreads = 128;   // tiled path's sweep
constexpr int kMaxK = 8192;          // tiled path: 128 words, 4 per lane
constexpr int kLongThreads = 512;    // long path's sweep

// IoU(a, b) > thr, the reference's arithmetic in the reference's order.
__device__ __forceinline__ bool suppresses(float4 a, float area_a, float4 b,
                                           float area_b, float thr) {
  const float iw = fmaxf(__fsub_rn(fminf(b.z, a.z), fmaxf(b.x, a.x)), 0.0f);
  const float ih = fmaxf(__fsub_rn(fminf(b.w, a.w), fmaxf(b.y, a.y)), 0.0f);
  const float inter = __fmul_rn(iw, ih);
  if (inter == 0.0f) return 0.0f > thr;
  const float uni = __fsub_rn(__fadd_rn(area_b, area_a), inter);
  return __fdiv_rn(inter, fmaxf(uni, 1e-9f)) > thr;
}

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

// Bits [0, n) of a word, n in [0, 64].
__device__ __forceinline__ u64 low_bits(int n) {
  return n >= 64 ? ~0ull : (1ull << n) - 1ull;
}

// Bits above b, b in [0, 63].
__device__ __forceinline__ u64 bits_above(int b) {
  return (~0ull << b) << 1;
}

// The valid bits of candidates [0, words * 64) into s_valid (two 32-bit
// halves per word, by ballot); returns the end of the valid prefix, the
// same in every thread. Every thread of the block must call it: it holds
// a barrier.
__device__ int valid_prefix(const float* scores, int k, int words,
                            float score_thr, unsigned* s_valid) {
  const int lane = threadIdx.x & 31;
  for (int j0 = (threadIdx.x >> 5) * 32; j0 < words * kTile;
       j0 += blockDim.x) {
    const int j = j0 + lane;
    const bool valid = j < k && scores[j] > score_thr;
    const unsigned v = __ballot_sync(kFull, valid);
    if (lane == 0) s_valid[j0 / 32] = v;
  }
  __syncthreads();
  // every warp reduces the halves itself: no second barrier
  unsigned last = 0;
  for (int h = lane; h < 2 * words; h += 32) {
    if (s_valid[h]) last = h * 32 + 32 - __clz(s_valid[h]);
  }
  return static_cast<int>(__reduce_max_sync(kFull, last));
}

__device__ __forceinline__ u64 valid_word(const unsigned* s_valid, int w) {
  return static_cast<u64>(s_valid[2 * w]) |
         (static_cast<u64>(s_valid[2 * w + 1]) << 32);
}

// The word of row i (box bi, area ai) over the 64 boxes at cols (areas at
// areas) in shared memory: bit c set when c is in `todo` and i suppresses
// column c. One warp, two columns a lane, one ballot each; lanes off
// `todo` test nothing.
__device__ __forceinline__ u64 row_word(float4 bi, float ai,
                                        const float4* cols,
                                        const float* areas, u64 todo,
                                        float iou_thr) {
  const int lane = threadIdx.x & 31;
  const bool lo = ((todo >> lane) & 1ull) &&
                  suppresses(bi, ai, cols[lane], areas[lane], iou_thr);
  const bool hi = ((todo >> (lane + 32)) & 1ull) &&
                  suppresses(bi, ai, cols[lane + 32], areas[lane + 32],
                             iou_thr);
  return static_cast<u64>(__ballot_sync(kFull, lo)) |
         (static_cast<u64>(__ballot_sync(kFull, hi)) << 32);
}

// ---- block path -----------------------------------------------------------

// One block per problem, the valid prefix's boxes and the removed bitset
// in shared memory. Per 64-candidate tile: warp 0 walks the chain through
// the tile, computing the diagonal word of each candidate it keeps (and
// no other); then every warp computes the kept candidates' words against
// the later tiles, a warp a word, OR-ed into the bitset with shared
// atomics. Columns already removed are not tested.
__global__ void __launch_bounds__(kBlockThreads)
nms_block_kernel(const float4* __restrict__ boxes,
                 const float* __restrict__ scores, bool* __restrict__ keep,
                 int k, float iou_thr, float score_thr) {
  __shared__ float4 s_box[kBlockMaxK];
  __shared__ float s_area[kBlockMaxK];
  __shared__ unsigned s_valid[kBlockMaxK / 32];
  __shared__ u64 s_removed[kBlockMaxK / kTile];
  __shared__ int s_kept[kTile];
  __shared__ int s_n_kept;

  constexpr int kWarps = kBlockThreads / 32;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * k;
  const int words = (k + kTile - 1) / kTile;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int bound = valid_prefix(scores + base, k, words, score_thr, s_valid);
  for (int j = tid; j < bound; j += kBlockThreads) {
    const float4 b = boxes[base + j];
    s_box[j] = b;
    s_area[j] = box_area(b);
  }
  if (tid < words) s_removed[tid] = ~valid_word(s_valid, tid);
  const int tiles = (bound + kTile - 1) / kTile;
  __syncthreads();

  for (int t = 0; t < tiles; ++t) {
    const int row0 = t * kTile;
    // 1. the chain through the tile: warp 0, every lane alike
    if (warp == 0) {
      const u64 in_tile = low_bits(bound - row0);
      u64 cur = s_removed[t];
      u64 todo = ~cur & in_tile;
      int n = 0;
      while (todo) {
        const int b = __ffsll(static_cast<long long>(todo)) - 1;
        cur |= row_word(s_box[row0 + b], s_area[row0 + b], s_box + row0,
                        s_area + row0, ~cur & in_tile & bits_above(b),
                        iou_thr);
        if (tid == 0) s_kept[n] = row0 + b;
        ++n;
        todo = ~cur & in_tile & bits_above(b);
      }
      if (tid == 0) {
        s_removed[t] = cur;
        s_n_kept = n;
      }
    }
    __syncthreads();
    // 2. the kept candidates against the later tiles: a warp per word
    const int n = s_n_kept;
    const int later = tiles - t - 1;
    for (int it = warp; it < n * later; it += kWarps) {
      const int i = s_kept[it % n];
      const int w = t + 1 + it / n;
      // bits only ever get set, so a stale read only costs extra tests
      const u64 todo = ~*const_cast<volatile u64*>(&s_removed[w]) &
                       low_bits(bound - w * kTile);
      const u64 word = row_word(s_box[i], s_area[i], s_box + w * kTile,
                                s_area + w * kTile, todo, iou_thr);
      if ((tid & 31) == 0 && word) atomicOr(&s_removed[w], word);
    }
    __syncthreads();
  }
  for (int j = tid; j < k; j += kBlockThreads) {
    keep[base + j] = !((s_removed[j / kTile] >> (j % kTile)) & 1ull);
  }
}

// ---- tiled path -----------------------------------------------------------

// mask: (P, K, words) u64; 2 * words * 4 bytes of dynamic shared memory.
// Block (p, g) of a (P, groups) grid walks the
// tiles (64 rows, 64 columns on or above the diagonal) inside problem p's
// valid prefix, g, g + groups, ...: no block is spent past the prefix.
// A warp per row, two columns a lane; rows that are not valid are skipped
// and their words left unwritten (the sweep never reads them).
__global__ void __launch_bounds__(kMaskThreads)
nms_mask_kernel(const float4* __restrict__ boxes,
                const float* __restrict__ scores, u64* __restrict__ mask,
                int k, int words, float iou_thr, float score_thr) {
  __shared__ float4 s_row[kTile], s_col[kTile];
  __shared__ float s_row_area[kTile], s_col_area[kTile];
  extern __shared__ unsigned s_valid[];  // [2 * words]: any K

  constexpr int kWarps = kMaskThreads / 32;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * k;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int bound = valid_prefix(scores + base, k, words, score_thr, s_valid);
  const int tiles = (bound + kTile - 1) / kTile;
  const int pairs = tiles * (tiles + 1) / 2;
  int rt = 0, first = 0;  // first pair index of row tile rt
  for (int q = blockIdx.y; q < pairs; q += gridDim.y) {
    while (q >= first + tiles - rt) {
      first += tiles - rt;
      ++rt;
    }
    const int ct = rt + (q - first);
    if (tid < kTile) {
      const int i = rt * kTile + tid;
      if (i < bound) {
        const float4 b = boxes[base + i];
        s_row[tid] = b;
        s_row_area[tid] = box_area(b);
      }
    } else {
      const int j = ct * kTile + tid - kTile;
      if (j < bound) {
        const float4 b = boxes[base + j];
        s_col[tid - kTile] = b;
        s_col_area[tid - kTile] = box_area(b);
      }
    }
    __syncthreads();
    const u64 rows = valid_word(s_valid, rt) & low_bits(bound - rt * kTile);
    const u64 cols = valid_word(s_valid, ct) & low_bits(bound - ct * kTile);
    for (int r = warp; r < kTile; r += kWarps) {
      if ((rows >> r) & 1ull) {
        const u64 w = row_word(s_row[r], s_row_area[r], s_col, s_col_area,
                               ct == rt ? cols & bits_above(r) : cols,
                               iou_thr);
        if ((tid & 31) == 0) mask[(base + rt * kTile + r) * words + ct] = w;
      }
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The chain through tile w: rows [64 w, 64 w + lim) of the mask, row b at
// rows + b * words, words [w, tiles) of each read. Lane l holds word
// q * 32 + l of the removed bitset in removed[q]. Every lane runs the same
// steps.
template <int kWordsPerLane>
__device__ void sweep_tile(const u64* rows, int w, int lim, int words,
                           int tiles, u64 (&removed)[kWordsPerLane]) {
  const int lane = threadIdx.x & 31;
  u64 cur = 0ull;
#pragma unroll
  for (int q = 0; q < kWordsPerLane; ++q) {
    if (q == w / 32) cur = __shfl_sync(kFull, removed[q], w % 32);
  }
  const u64 live = low_bits(lim);
  u64 todo = ~cur & live;
  while (todo) {
    const int b = __ffsll(static_cast<long long>(todo)) - 1;
    const u64* row = rows + b * words;
    cur |= row[w];
#pragma unroll
    for (int q = 0; q < kWordsPerLane; ++q) {
      const int l = q * 32 + lane;
      if (l > w && l < tiles) removed[q] |= row[l];
    }
    todo = ~cur & live & bits_above(b);
  }
#pragma unroll
  for (int q = 0; q < kWordsPerLane; ++q) {
    if (q == w / 32 && lane == w % 32) removed[q] = cur;
  }
}

template <int kWordsPerLane>
__global__ void __launch_bounds__(kSweepThreads)
nms_sweep_kernel(const float* __restrict__ scores,
                 const u64* __restrict__ mask, bool* __restrict__ keep, int k,
                 int words, float score_thr) {
  extern __shared__ u64 s_stage[];  // [2][64][words]
  __shared__ unsigned s_valid[kMaxK / 32];
  __shared__ u64 s_removed[kMaxK / kTile];

  const int64_t base = static_cast<int64_t>(blockIdx.x) * k;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int bound = valid_prefix(scores + base, k, words, score_thr, s_valid);
  const int tiles = (bound + kTile - 1) / kTile;
  u64 removed[kWordsPerLane];
#pragma unroll
  for (int q = 0; q < kWordsPerLane; ++q) {
    const int l = q * 32 + lane;
    removed[q] = l < words ? ~valid_word(s_valid, l) : ~0ull;
  }
  const u64* pm = mask + base * words;
  // rows [64 w, 64 w + 64) of the valid prefix, words [w, tiles): the mask
  // kernel writes no word past the prefix
  auto stage = [&](int w) {
    u64* dst = s_stage + (w & 1) * kTile * words;
    const int rows = min(kTile, bound - w * kTile);
    const int nw = tiles - w;
    for (int it = tid; it < rows * nw; it += kSweepThreads) {
      const int r = it / nw;
      const int l = w + it % nw;
      cp_async8(dst + r * words + l, pm + (w * kTile + r) * words + l);
    }
    cp_async_commit();
  };
  if (tiles > 0) stage(0);
  for (int w = 0; w < tiles; ++w) {
    if (w + 1 < tiles) {
      stage(w + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (tid < 32) {
      sweep_tile<kWordsPerLane>(s_stage + (w & 1) * kTile * words, w,
                                min(kTile, bound - w * kTile), words, tiles,
                                removed);
    }
    __syncthreads();
  }
  if (tid < 32) {
#pragma unroll
    for (int q = 0; q < kWordsPerLane; ++q) {
      const int l = q * 32 + lane;
      if (l < words) s_removed[l] = removed[q];
    }
  }
  __syncthreads();
  for (int j = tid; j < k; j += kSweepThreads) {
    keep[base + j] = !((s_removed[j / kTile] >> (j % kTile)) & 1ull);
  }
}

// The long path's sweep (K > 8,192), one block a problem. Dynamic shared
// memory: the removed bitset (words u64), the diagonal words of the
// current tile's rows (64 u64) and the valid bits (2 * words u32).
__global__ void __launch_bounds__(kLongThreads)
nms_sweep_long_kernel(const float* __restrict__ scores,
                      const u64* __restrict__ mask, bool* __restrict__ keep,
                      int k, int words, float score_thr) {
  extern __shared__ u64 s_dyn[];
  u64* s_removed = s_dyn;
  u64* s_diag = s_dyn + words;
  unsigned* s_valid = reinterpret_cast<unsigned*>(s_diag + kTile);
  __shared__ int s_kept[kTile];
  __shared__ int s_n_kept;

  const int64_t base = static_cast<int64_t>(blockIdx.x) * k;
  const int tid = threadIdx.x;
  const int bound = valid_prefix(scores + base, k, words, score_thr, s_valid);
  const int tiles = (bound + kTile - 1) / kTile;
  for (int l = tid; l < words; l += kLongThreads) {
    s_removed[l] = ~valid_word(s_valid, l);
  }
  const u64* pm = mask + base * words;
  for (int w = 0; w < tiles; ++w) {
    const int lim = min(kTile, bound - w * kTile);
    // column piece w of the tile's rows; rows that are not valid were
    // never written, and the chain never reads them
    if (tid < lim) {
      s_diag[tid] = pm[static_cast<int64_t>(w * kTile + tid) * words + w];
    }
    __syncthreads();  // also orders the last tile's ORs before the chain
    // 1. the chain through the tile: warp 0, every lane alike
    if (tid < 32) {
      const u64 live = low_bits(lim);
      u64 cur = s_removed[w];
      u64 todo = ~cur & live;
      int n = 0;
      while (todo) {
        const int b = __ffsll(static_cast<long long>(todo)) - 1;
        if (tid == 0) s_kept[n] = w * kTile + b;
        ++n;
        cur |= s_diag[b];
        todo = ~cur & live & bits_above(b);
      }
      if (tid == 0) {
        s_removed[w] = cur;
        s_n_kept = n;
      }
    }
    __syncthreads();
    // 2. the kept rows' later column pieces: a thread a (row, word),
    // neighbouring threads on neighbouring words of a row, OR-ed into the
    // bitset with shared atomics
    const int later = tiles - w - 1;
    const int items = s_n_kept * later;
#pragma unroll 4
    for (int it = tid; it < items; it += kLongThreads) {
      const int l = w + 1 + it % later;
      const u64 word =
          pm[static_cast<int64_t>(s_kept[it / later]) * words + l];
      if (word) atomicOr(&s_removed[l], word);
    }
    __syncthreads();  // s_kept and s_diag are rewritten by the next tile
  }
  __syncthreads();
  for (int j = tid; j < k; j += kLongThreads) {
    keep[base + j] = !((s_removed[j / kTile] >> (j % kTile)) & 1ull);
  }
}

// Dynamic shared memory above 48 KB must be asked for.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int kWordsPerLane>
int launch_sweep(const float* scores, const u64* mask, bool* keep, int p,
                 int k, int words, float score_thr, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(2) * kTile * words * sizeof(u64);
  const cudaError_t e = allow_smem(nms_sweep_kernel<kWordsPerLane>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  nms_sweep_kernel<kWordsPerLane><<<p, kSweepThreads, smem, stream>>>(
      scores, mask, keep, k, words, score_thr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// boxes: (p, k, 4) f32, 16-byte aligned; scores: (p, k) f32; keep: (p, k)
// bool; scratch: (p, k, ceil(k / 64)) u64 for launches 2 and 3, unused for
// launch 1. All contiguous on the current device; stream is a cudaStream_t.
// launch: 1 = block (k <= 512), 2 = tiled (k <= 8,192), 3 = long (any k).
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int nms_keep_batch(const void* boxes, const void* scores,
                              void* keep, void* scratch, int p, int k,
                              float iou_threshold, float score_threshold,
                              int launch, void* stream) {
  if (p == 0 || k == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int words = (k + kTile - 1) / kTile;
  const float4* bx = static_cast<const float4*>(boxes);
  const float* sc = static_cast<const float*>(scores);
  bool* kp = static_cast<bool*>(keep);
  if (launch == 1) {
    if (k > kBlockMaxK) return static_cast<int>(cudaErrorInvalidValue);
    nms_block_kernel<<<p, kBlockThreads, 0, s>>>(bx, sc, kp, k, iou_threshold,
                                                 score_threshold);
    return static_cast<int>(cudaGetLastError());
  }
  if ((launch != 2 && launch != 3) || (launch == 2 && k > kMaxK) ||
      scratch == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  u64* mask = static_cast<u64*>(scratch);
  // about 8 blocks an SM over the whole grid, at most one per tile pair
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const int pairs = words * (words + 1) / 2;
  int groups = (sms * 8 + p - 1) / p;
  if (groups > pairs) groups = pairs;
  if (groups > 65535) groups = 65535;
  const size_t valid_smem = static_cast<size_t>(2) * words * sizeof(unsigned);
  e = allow_smem(nms_mask_kernel, valid_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  nms_mask_kernel<<<dim3(p, groups), kMaskThreads, valid_smem, s>>>(
      bx, sc, mask, k, words, iou_threshold, score_threshold);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (launch == 3) {
    const size_t smem = static_cast<size_t>(words + kTile) * sizeof(u64) +
                        valid_smem;
    e = allow_smem(nms_sweep_long_kernel, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    nms_sweep_long_kernel<<<p, kLongThreads, smem, s>>>(
        sc, mask, kp, k, words, score_threshold);
    return static_cast<int>(cudaGetLastError());
  }
  return words <= 32
             ? launch_sweep<1>(sc, mask, kp, p, k, words, score_threshold, s)
             : launch_sweep<4>(sc, mask, kp, p, k, words, score_threshold, s);
}
