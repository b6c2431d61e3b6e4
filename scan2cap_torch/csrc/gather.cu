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
// Design: a warp per 32 consecutive output rows of one scene.  Lane l
// reads the index of row l (one coalesced load for 32 rows).  The 32 rows
// are one contiguous stretch of the output, 32 * w vectors long; the warp
// walks it 32 vectors at a time, so every store instruction is one full,
// contiguous, coalesced write whatever the row width, and no lane idles on
// a ragged width (138 floats are 69 8-byte vectors).  A lane keeps the
// (row, column) of its vector by adding 32 % w columns and 32 / w rows per
// step, gets the row's index from the lane that loaded it by shuffle, and
// has eight loads in flight before its first store.  The copy uses the
// widest vector that the row width and both base pointers allow: 16 bytes,
// 8 bytes (every even width, the 138-wide backward gather among them) or 4
// bytes; the caller (kernels/gather.py) makes that choice and passes it
// in.  The scene is blockIdx.y and all offsets inside a scene are 32-bit:
// no division is on the path (two per thread before the loop), and the only
// 64-bit arithmetic is one widening multiply-add per load.  The stores are
// streaming (__stcs) so that the output, which is never read here, does not
// push the table out of L2.  Indices must lie in [0, N): that is the
// caller's contract, as in the JAX op.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kInFlight = 8;     // loads of a lane before its first store
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 132 * 16;
constexpr unsigned kFull = 0xffffffffu;

// V is float4, float2 or float; `w` is the row width in units of V.
template <typename V>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const V* __restrict__ feat, const int* __restrict__ idx,
                   int n_batch, int n_points, unsigned n_rows, unsigned w,
                   V* __restrict__ out) {
  const unsigned lane = threadIdx.x & 31;
  const unsigned rows_on = 32 / w, cols_on = 32 % w;   // 32 vectors further
  const unsigned row0 = lane / w, col0 = lane % w;
  const unsigned warp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const unsigned step = gridDim.x * kWarps * 32;
  for (int b = blockIdx.y; b < n_batch; b += gridDim.y) {
    const V* table = feat + static_cast<size_t>(b) * n_points * w;
    const int* rows = idx + static_cast<size_t>(b) * n_rows;
    V* dst = out + static_cast<size_t>(b) * n_rows * w;
    // every trip count below is the same for all lanes of a warp (the
    // shuffle needs them all)
    for (unsigned base = warp * 32; base < n_rows; base += step) {
      const unsigned here = n_rows - base < 32 ? n_rows - base : 32;
      const int mine = lane < here ? __ldg(rows + base + lane) : 0;
      const unsigned count = here * w;           // vectors of this stretch
      V* to = dst + static_cast<size_t>(base) * w;
      unsigned row = row0, col = col0;
      for (unsigned e0 = lane; e0 < count + lane; e0 += 32 * kInFlight) {
        V v[kInFlight];
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          const int src = __shfl_sync(kFull, mine, row & 31);
          if (e0 + 32 * u < count)
            v[u] = __ldg(table + static_cast<size_t>(src) * w + col);
          row += rows_on;
          col += cols_on;
          if (col >= w) {
            col -= w;
            ++row;
          }
        }
#pragma unroll
        for (int u = 0; u < kInFlight; ++u)
          if (e0 + 32 * u < count) __stcs(to + e0 + 32 * u, v[u]);
      }
    }
  }
}

template <typename V>
cudaError_t launch(const void* feat, const int* idx, int B, int N, int R,
                   int w, void* out, cudaStream_t stream) {
  const int by = B < 65535 ? B : 65535;
  int bx = (R + kWarps * 32 - 1) / (kWarps * 32);
  const int most = kMaxBlocks / by > 0 ? kMaxBlocks / by : 1;
  if (bx > most) bx = most;
  gather_rows_kernel<V><<<dim3(bx, by), kThreads, 0, stream>>>(
      static_cast<const V*>(feat), idx, B, N, static_cast<unsigned>(R),
      static_cast<unsigned>(w), static_cast<V*>(out));
  return cudaGetLastError();
}

}  // namespace

// feat (B, N, C) float32, idx (B, R) int32, out (B, R, C) float32, all
// contiguous.  `vec_bytes` is 16, 8 or 4 and must divide the row's bytes
// and both base addresses.  Returns the launch's cudaError_t (0 on
// success).
extern "C" int gather_rows_launch(const void* feat, const void* idx, int B,
                                  int N, int R, int C, int vec_bytes,
                                  void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ix = static_cast<const int*>(idx);
  if (vec_bytes != 4 && vec_bytes != 8 && vec_bytes != 16)
    return cudaErrorInvalidValue;
  const int per = vec_bytes / 4;
  if (C % per != 0 || reinterpret_cast<size_t>(feat) % vec_bytes != 0 ||
      reinterpret_cast<size_t>(out) % vec_bytes != 0)
    return cudaErrorInvalidValue;
  if (B == 0 || R == 0 || C == 0) return 0;
  const int w = C / per;
  if (vec_bytes == 16)
    return (int)launch<float4>(feat, ix, B, N, R, w, out, s);
  if (vec_bytes == 8)
    return (int)launch<float2>(feat, ix, B, N, R, w, out, s);
  return (int)launch<float>(feat, ix, B, N, R, w, out, s);
}
