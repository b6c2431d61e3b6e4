// Pack-tile probes for Hopper (sm_90a): the (256, 512) hit tile times the
// (512, 48) power-of-two pack matrix, and the integer combines of its
// half-words.
//
// Replaces the TPU kernels scripts/micro_mxu_pack_probe.py (_probe_kernel
// :31, launched by probe :46) and scripts/micro_mxu_shift_probe.py (_kernel
// :30, launched by probe :51).  Both feed a crafted 0/1 hit tile through
// the product that the TPU ball query packs its hit words with
// (scan2cap_tpu/ops/pallas/ballquery.py:42-55): column k < 16 of the
// product is the low half-word of word k (sum of hit[32k + b] * 2^b,
// b < 16), column 16 + k the high half-word (bits 16..31), column 32 + k
// the word's popcount.  On the TPU the probes found that the product is
// exact and that a shift of a value just converted from float is not; here
// they hold this card's float product, its float-to-int conversion and its
// integer shifts to the same questions.
//   * pack_probe: raw (256, 128) float32 = the product in columns 0..47,
//     zeros after; word (256, 128) int32 = lo | (hi << 16) in columns
//     0..15, zeros after.
//   * shift_probe: six (256, 128) int32 outputs, columns 0..15 each:
//     v0 lo | (hi << 16), v1 lo | (hi * 65536), v2 lo + (hi << 16),
//     v3 lo | ((hi << 8) << 8), v4 ints << 16 for an integer input,
//     v5 lo | (hi << s) with the shift count s = 16 read from memory.
//
// What bounds it on the H100: neither bytes nor operations to any effect.
// The tile is 512 KB in and at most 768 KB out, and the product is
// 256*48*512 multiply-adds (12.6 MFLOP): both bounds are under a
// microsecond, so the launch itself is the cost.
//
// Design: one block per tile row, 128 threads.  The row's 512 hit values
// go to shared memory once; thread k < 48 accumulates output column k over
// all 512 points in point order with one fused multiply-add each, the
// weight of (point, column) computed in registers from the pack matrix's
// rule, so the matrix is never stored.  With 0/1 hits every partial sum is
// an integer below 2^16 and exact in float32 whatever the order.  The
// columns then pass through shared memory to the threads that combine
// them.  Shifts and the multiply are done on unsigned values (the bit
// pattern of the int32 result): hi = 65535 sets bit 31.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 256;     // query rows of the tile (_MQ)
constexpr int kPoints = 512;   // points per pack step (_NC)
constexpr int kCols = 48;      // 16 lo + 16 hi + 16 count columns
constexpr int kOutCols = 128;  // lane-padded output width
constexpr int kWords = 16;

// Entry (n, k) of the pack matrix.
__device__ __forceinline__ float pack_weight(int n, int k) {
  const int word = n >> 5;
  const int bit = n & 31;
  if (k < 16) return (k == word && bit < 16) ? (float)(1u << bit) : 0.0f;
  if (k < 32)
    return (k - 16 == word && bit >= 16) ? (float)(1u << (bit - 16)) : 0.0f;
  return (k - 32 == word) ? 1.0f : 0.0f;
}

// The product row: packed[k] = sum_n hit[row, n] * P[n, k], k < 48.
__device__ __forceinline__ void product_row(const float* __restrict__ hit,
                                            float* s_hit, float* s_packed) {
  const int row = blockIdx.x;
  const int k = threadIdx.x;
  for (int n = k; n < kPoints; n += blockDim.x)
    s_hit[n] = hit[row * kPoints + n];
  __syncthreads();
  if (k < kCols) {
    float acc = 0.0f;
    for (int n = 0; n < kPoints; ++n)
      acc = __fmaf_rn(s_hit[n], pack_weight(n, k), acc);
    s_packed[k] = acc;
  }
  __syncthreads();
}

__global__ void pack_probe_kernel(const float* __restrict__ hit,
                                  float* __restrict__ raw,
                                  int* __restrict__ word) {
  __shared__ float s_hit[kPoints];
  __shared__ float s_packed[kCols];
  product_row(hit, s_hit, s_packed);
  const int k = threadIdx.x;
  const int o = blockIdx.x * kOutCols + k;
  raw[o] = k < kCols ? s_packed[k] : 0.0f;
  int w = 0;
  if (k < kWords) {
    const unsigned lo = (unsigned)(int)s_packed[k];
    const unsigned hi = (unsigned)(int)s_packed[kWords + k];
    w = (int)(lo | (hi << 16));
  }
  word[o] = w;
}

__global__ void shift_probe_kernel(const float* __restrict__ hit,
                                   const int* __restrict__ ints,
                                   const int* __restrict__ shift_count,
                                   int* __restrict__ v0, int* __restrict__ v1,
                                   int* __restrict__ v2, int* __restrict__ v3,
                                   int* __restrict__ v4,
                                   int* __restrict__ v5) {
  __shared__ float s_hit[kPoints];
  __shared__ float s_packed[kCols];
  product_row(hit, s_hit, s_packed);
  const int k = threadIdx.x;
  const int o = blockIdx.x * kOutCols + k;
  unsigned r0 = 0, r1 = 0, r2 = 0, r3 = 0, r4 = 0, r5 = 0;
  if (k < kWords) {
    const unsigned lo = (unsigned)(int)s_packed[k];
    const unsigned hi = (unsigned)(int)s_packed[kWords + k];
    r0 = lo | (hi << 16);
    r1 = lo | (hi * 65536u);
    r2 = lo + (hi << 16);
    r3 = lo | ((hi << 8) << 8);
    r4 = (unsigned)ints[o] << 16;
    r5 = lo | (hi << (shift_count[k] & 31));
  }
  v0[o] = (int)r0;
  v1[o] = (int)r1;
  v2[o] = (int)r2;
  v3[o] = (int)r3;
  v4[o] = (int)r4;
  v5[o] = (int)r5;
}

}  // namespace

// hit (256, 512) float32 -> raw (256, 128) float32, word (256, 128) int32.
extern "C" int pack_probe_launch(const void* hit, void* raw, void* word,
                                 void* stream) {
  pack_probe_kernel<<<kRows, kOutCols, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(hit), static_cast<float*>(raw),
      static_cast<int*>(word));
  return (int)cudaGetLastError();
}

// hit (256, 512) float32, ints (256, 128) int32, shift_count (16,) int32
// -> six (256, 128) int32 outputs, contiguous in `out` (6, 256, 128).
extern "C" int shift_probe_launch(const void* hit, const void* ints,
                                  const void* shift_count, void* out,
                                  void* stream) {
  int* o = static_cast<int*>(out);
  const int n = kRows * kOutCols;
  shift_probe_kernel<<<kRows, kOutCols, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(hit), static_cast<const int*>(ints),
      static_cast<const int*>(shift_count), o, o + n, o + 2 * n, o + 3 * n,
      o + 4 * n, o + 5 * n);
  return (int)cudaGetLastError();
}

extern "C" int pack_probe_rows() { return kRows; }
extern "C" int pack_probe_points() { return kPoints; }
