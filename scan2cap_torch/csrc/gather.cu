// Row gather for Hopper (sm_90a): out[b, r, :] = features[b, idx[b, r], :].
//
// Replaces the TPU kernels of scripts/micro_vmem_gather.py (vmem_gather :50
// and its 4-way unrolled twin vmem_gather_vec :83, one function): the sa1
// neighbour gather, 2048 x 64 row reads of a per-scene (N, C) float32
// table, and with it every group_points of the model (features (B, N, C),
// idx (B, M, S) -> (B, M, S, C), any C).  The TPU kernel stages the whole
// table in on-chip memory because its gathers cost a fixed time per row;
// on this card the table (10 MB per scene at sa1) stays in the 50 MB L2
// and a row read is an ordinary coalesced load, so nothing is staged.
//
// What bounds it on the H100: bytes.  Each output element is written once
// (B*M*S*C*4 bytes, 67 MB at sa1 with B=2) and the table is read from
// device memory once; there is no arithmetic.
//
// Design: one thread per 16-byte piece of an output row (float4 when C is
// a multiple of 4, else one thread per float), pieces numbered row-major
// so that neighbouring threads write neighbouring addresses and read
// neighbouring addresses of one table row; a grid-stride loop covers any
// size.  Every thread of a row loads the row's index itself (one cached
// 4-byte read).  Indices must lie in [0, N): that is the caller's
// contract, as in the JAX op.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

// T is float4 or float; `w` is the row width in units of T.
template <typename T>
__global__ void gather_rows_kernel(const T* __restrict__ feat,
                                   const int* __restrict__ idx,
                                   long long n_rows, long long rows_per_batch,
                                   long long n_points, int w,
                                   T* __restrict__ out) {
  const long long total = n_rows * w;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const long long row = t / w;
    const int col = (int)(t - row * w);
    const long long b = row / rows_per_batch;
    const long long src = b * n_points + __ldg(idx + row);
    out[t] = __ldg(feat + src * w + col);
  }
}

template <typename T>
cudaError_t launch(const void* feat, const int* idx, long long n_rows,
                   long long rows_per_batch, long long n_points, int w,
                   void* out, cudaStream_t stream) {
  const long long total = n_rows * w;
  if (total == 0) return cudaSuccess;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  gather_rows_kernel<T><<<(int)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(feat), idx, n_rows, rows_per_batch, n_points, w,
      static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace

// feat (B, N, C) float32, idx (B, R) int32, out (B, R, C) float32, all
// contiguous.  Returns the launch's cudaError_t (0 on success).
extern "C" int gather_rows_launch(const void* feat, const void* idx, int B,
                                  int N, int R, int C, void* out,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_rows = (long long)B * R;
  const int* ix = static_cast<const int*>(idx);
  if (C % 4 == 0)
    return (int)launch<float4>(feat, ix, n_rows, R, N, C / 4, out, s);
  return (int)launch<float>(feat, ix, n_rows, R, N, C, out, s);
}
