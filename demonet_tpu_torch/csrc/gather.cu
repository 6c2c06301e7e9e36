// Batched row gather: out[b, r] = table[b, idx[b, r]] over 4-wide f32 rows.
//
// Replaces the TPU kernel demonet_tpu/ops/gather_pallas.py::
// gather_rows_batch (_gather_kernel, :59; pl.pallas_call, :124). The TPU
// version is an exact one-hot matmul on the MXU with the table split into
// three bf16 pieces; Hopper gathers directly, so none of that carries
// over. Same contract: table (B, N, 4) f32, idx (B, R) int32 in [0, N)
// (not checked on the device, as on the TPU); out (B, R, 4), or (B, 4, R)
// with coord_major. It copies bits and does no arithmetic, so it is
// bit-equal to torch.gather, denormals, -0.0 and +-1e30 included.
//
// What bounds it on this card: bytes. The reference postprocess calls it
// twice per batch: the candidate gather (N = 3,234, R = 27,000, a table
// small enough to stay in L2 while 27,000 rows per image are written) and
// the final gather (N = 27,000, R = 300). Each row is one 16-byte load and
// one 16-byte store.
//
// Design: one thread per output row, a float4 load of the row and a float4
// store (row-major) or four 4-byte stores into the coordinate planes
// (coord_major), neighbouring threads on neighbouring output rows so the
// stores coalesce.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const float4* __restrict__ table,
                   const int* __restrict__ idx, float4* __restrict__ out,
                   int n, int r, int64_t total) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int64_t b = t / r;
  out[t] = table[b * n + idx[t]];
}

__global__ void __launch_bounds__(kThreads)
gather_rows_coord_major_kernel(const float4* __restrict__ table,
                               const int* __restrict__ idx,
                               float* __restrict__ out, int n, int r,
                               int64_t total) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int64_t b = t / r;
  const float4 v = table[b * n + idx[t]];
  float* o = out + b * 4 * r + (t - b * r);
  o[0] = v.x;
  o[r] = v.y;
  o[2 * static_cast<int64_t>(r)] = v.z;
  o[3 * static_cast<int64_t>(r)] = v.w;
}

}  // namespace

// table: (b, n, 4) f32, 16-byte aligned; idx: (b, r) int32; out: (b, r, 4)
// f32 (16-byte aligned) or, with coord_major != 0, (b, 4, r) f32. All
// contiguous on the current device; stream is a cudaStream_t. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int gather_rows_batch(const void* table, const void* idx,
                                 void* out, int b, int n, int r,
                                 int coord_major, void* stream) {
  const int64_t total = static_cast<int64_t>(b) * r;
  if (total == 0) return 0;
  const unsigned blocks =
      static_cast<unsigned>((total + kThreads - 1) / kThreads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* t4 = static_cast<const float4*>(table);
  const int* ix = static_cast<const int*>(idx);
  if (coord_major) {
    gather_rows_coord_major_kernel<<<blocks, kThreads, 0, s>>>(
        t4, ix, static_cast<float*>(out), n, r, total);
  } else {
    gather_rows_kernel<<<blocks, kThreads, 0, s>>>(
        t4, ix, static_cast<float4*>(out), n, r, total);
  }
  return static_cast<int>(cudaGetLastError());
}
