// Chunk-skipping exact top-k of thresholded score rows.
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
// slot are written; the sort works in shared memory and needs no device
// memory traffic.
//
// Design: one block per row.
//   1. Each warp takes 128-wide chunks of the row and a ballot says whether
//      the chunk holds a score above thresh; warp 0 then ballots the chunk
//      flags (A <= 4,096, so at most 32 chunks: one bit each) and a
//      popcount of the lower bits gives each live chunk its slot. This is
//      the per-lane compaction the TPU could not vectorize, done with two
//      ballots and no scan over memory.
//   2. A row with no live chunk writes padding and exits (most rows of a
//      trained model).
//   3. A row with at most `slots` live chunks copies them, in ascending
//      chunk order, into a buffer of slots * 128 entries (rounded up to a
//      power of two) in shared memory, with each entry's global index.
//   4. A row with more live chunks than `slots` takes its whole masked row
//      instead (A padded to a power of two, 4,096 at most: 32 KB). The TPU
//      version falls back to a dense top-k for the whole call when any row
//      overflows (lax.cond); here the choice is per row, inside the kernel,
//      so the kernel always launches, needs no host sync and is exact on
//      every input.
//   5. A bitonic sort of the buffer (key descending, index ascending on
//      equal keys); the first k entries are written, dead ones as padding.
// Padding entries of the buffer carry indices >= A, so every index in the
// buffer is distinct and the sort order is total.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 128;
constexpr int kMaxChunks = 32;

// (ka, ia) comes before (kb, ib) in the output order.
__device__ __forceinline__ bool before(float ka, int ia, float kb, int ib) {
  return ka > kb || (ka == kb && ia < ib);
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
                   int slots, int compact_width, int row_width) {
  extern __shared__ float smem[];
  float* key = smem;
  int* idx = reinterpret_cast<int*>(smem + row_width);
  __shared__ int s_live[kMaxChunks];
  __shared__ int s_chunk_of_slot[kMaxChunks];
  __shared__ unsigned s_mask;

  const float neg_inf = -CUDART_INF_F;
  const int chunks = (a + kChunk - 1) / kChunk;
  const float* row = scores + static_cast<int64_t>(blockIdx.x) * a;
  float* osc = out_sc + static_cast<int64_t>(blockIdx.x) * k;
  int* oidx = out_idx + static_cast<int64_t>(blockIdx.x) * k;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // 1. which chunks hold a live score: one ballot per chunk
  for (int c = warp; c < chunks; c += kThreads / 32) {
    bool any = false;
    for (int j = lane; j < kChunk; j += 32) {
      const int col = c * kChunk + j;
      any |= col < a && row[col] > thresh;
    }
    const unsigned hit = __ballot_sync(0xffffffffu, any);
    if (lane == 0) s_live[c] = hit != 0u;
  }
  __syncthreads();
  // ... and each live chunk's slot: a ballot over the chunk flags
  if (warp == 0) {
    const bool live = lane < chunks && s_live[lane];
    const unsigned mask = __ballot_sync(0xffffffffu, live);
    if (live) s_chunk_of_slot[__popc(mask & ((1u << lane) - 1u))] = lane;
    if (lane == 0) s_mask = mask;
  }
  __syncthreads();
  const int n_live = __popc(s_mask);

  // 2. nothing above thresh: all padding
  if (n_live == 0) {
    for (int j = threadIdx.x; j < k; j += kThreads) {
      osc[j] = neg_inf;
      oidx[j] = 0;
    }
    return;
  }

  // 3./4. fill the buffer: the live chunks, or the whole row on overflow
  const bool compact = n_live <= slots && compact_width < row_width;
  const int width = compact ? compact_width : row_width;
  for (int t = threadIdx.x; t < width; t += kThreads) {
    int col = t;
    if (compact) {
      const int s = t / kChunk;
      col = s < n_live ? s_chunk_of_slot[s] * kChunk + t % kChunk : a;
    }
    float v = neg_inf;
    int ix = a + t;  // padding: an index past every real one
    if (col < a) {
      const float x = row[col];
      v = x > thresh ? x : neg_inf;
      ix = col;
    }
    key[t] = v;
    idx[t] = ix;
  }
  __syncthreads();

  // 5. sort and write the first k
  bitonic_sort(key, idx, width);
  for (int j = threadIdx.x; j < k; j += kThreads) {
    const float v = key[j];
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
  if (chunks > kMaxChunks || k > a || k > slots * kChunk) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int row_width = next_pow2(chunks * kChunk);
  const int compact_width = next_pow2(slots * kChunk);
  const size_t smem = static_cast<size_t>(row_width) * 2 * sizeof(float);
  topk_sparse_kernel<<<p, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scores), static_cast<float*>(out_sc),
      static_cast<int*>(out_idx), a, k, thresh, slots, compact_width,
      row_width);
  return static_cast<int>(cudaGetLastError());
}
