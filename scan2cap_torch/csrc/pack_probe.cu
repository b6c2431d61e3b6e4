// Pack-tile probes for Hopper (sm_90a): the (256, 512) hit tile times the
// (512, 48) power-of-two pack matrix on the tensor cores, and the integer
// combines of its half-words.
//
// Replaces the TPU kernels scripts/micro_mxu_pack_probe.py (_probe_kernel
// :31, launched by probe :46) and scripts/micro_mxu_shift_probe.py (_kernel
// :30, launched by probe :51).  Both feed a crafted 0/1 hit tile through
// the product that the TPU ball query packs its hit words with
// (scan2cap_tpu/ops/pallas/ballquery.py:42-55): column k < 16 of the
// product is the low half-word of word k (sum of hit[32k + b] * 2^b,
// b < 16), column 16 + k the high half-word (bits 16..31), column 32 + k
// the word's popcount.  The TPU probes asked whether the matrix unit's
// product is exact and whether the float-to-int conversion and the shifts
// after it are; here the product runs on this card's matrix unit, wgmma,
// and the same questions are put to it.
//   * pack_probe: raw (256, 128) float32 = the product in columns 0..47,
//     zeros after; word (256, 128) int32 = lo | (hi << 16) in columns
//     0..15, zeros after.
//   * shift_probe: six (256, 128) int32 outputs, columns 0..15 each:
//     v0 lo | (hi << 16), v1 lo | (hi * 65536), v2 lo + (hi << 16),
//     v3 lo | ((hi << 8) << 8), v4 ints << 16 for an integer input,
//     v5 lo | (hi << s) with the shift count s = 16 read from memory.
//
// What bounds it on the H100: bytes, and neither bound to any effect.  The
// pack probe reads the 512 KB tile and writes 256 KB (0.23 us at 3.35
// TB/s), the shift probe also reads 128 KB of ints and writes 768 KB (0.43
// us); the product is 12.6 MFLOP (0.03 us in tf32).  A launch costs more
// than both, so the design aims at a short critical path: every load in
// flight at once, nothing serial per output column.
//
// Exactness.  wgmma m64n48k8 reads tf32 operands (10 mantissa bits) and
// sums in float32.  With 0/1 hits every product is 0 or a power of two at
// most 2^15; every partial sum is an integer at most 65,535 (a count column
// at most 32): all exact in tf32 operands and in a float32 accumulator, in
// any order of summation.  So the result equals the plain float32
// torch.matmul bitwise, whatever order the tensor cores sum in.  A tile
// whose values are not 0/1 lies outside the probe's contract: tf32 would
// truncate it.
//
// Design: one warpgroup (128 threads) a block, one 64-row M tile of the
// tile's 256 rows; K = 512 points split over the kSplit blocks of a cluster
// (4 kSplit blocks in all).
//   * The hit tile arrives by TMA (cp.async.bulk.tensor.2d, 128-byte
//     swizzle) in boxes of 64 rows x 32 points (8 KB), one box per word,
//     all of a block's boxes in flight at once, each completing on its own
//     mbarrier.  The tensor map is encoded on the host by
//     cuTensorMapEncodeTiled, looked up at run time (no -lcuda), and kept
//     while the tile's address stays.
//   * The pack matrix is never read from memory.  Word j's slice of P^T
//     (48 x 32) is the same pattern moved down j rows, so one template of
//     63 rows (8 KB) in the plain core-matrix layout serves every word: its
//     descriptor starts 16 (15 - j) bytes in.  Each block writes it from
//     the rule while the boxes are in flight; fence.proxy.async makes the
//     generic stores visible to the tensor cores' async proxy before the
//     first wgmma.  (Sixteen swizzled 6 KB slices, the first design, took
//     longer to write than the whole kernel takes now.)
//   * Operands are K-major in shared memory, as tf32 wgmma needs both: the
//     hits' descriptor names the 128-byte swizzle, 8-row groups 1024 bytes
//     apart, a K step of 8 points 32 bytes on; the template's names no
//     swizzle, K chunks of 4 points 1008 bytes apart (LBO), 8-row groups
//     128 (SBO), a K step two chunks on.
//   * Each block holds partial sums of its M tile over its K slice; 8-row
//     group g of the tile is finished by block g / (8 / kSplit), and the
//     other blocks send it their partial sums of g with st.async, each
//     store completing its bytes on the owner's mbarrier: no cluster
//     barrier after the product, and every block writes its own rows.  The
//     sum is exact in any order (integers).  One relaxed cluster barrier at
//     the start, reached by every thread, keeps any block from writing into
//     one not yet running or armed.  (red.shared::cluster.add into one
//     leader serialised on its shared memory; stores and a second cluster
//     barrier cost more than st.async.)
//   * The epilogue stays in registers: thread `lane` of warp w holds rows
//     16w + lane/4 and +8, columns 8j + 2(lane%4) + {0, 1}; as 16 and 32
//     are multiples of 8, word k's low (k), high (16 + k) and count
//     (32 + k) columns lie in one thread.  Conversions truncate as astype;
//     shifts and the multiply act on the unsigned bit pattern (hi = 65535
//     sets bit 31).  Output rows go out as 8-byte stores from the
//     fragment (so `ints` must lie on an 8-byte boundary, and the hit tile
//     on a 16-byte one for its tensor map; the wrappers check both); the
//     zero padding (raw 48..127, words 16..127) as 16-byte stores by every
//     block for its share of rows while its boxes are in flight (bulk
//     stores from shared memory queued behind the loads in the TMA engine
//     and were slower).
// Partition: kSplit = 8 (32 blocks, 2 boxes each), the fastest on an H100
// 80GB HBM3 at 700 W of 1 (partition (a): 4 blocks, each walking all of K),
// 2, 4 and 8; the times of each, and the run they come from, are in
// PERF.md section 6 (scan2cap_torch/probes/pack_times.py on copies of this
// checkout with kSplit and kernels/pack_probe.py's SPLIT edited).

#include <cuda.h>           // CUtensorMap and its enums: types only
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

namespace {

constexpr int kRows = 256;       // query rows of the tile (_MQ)
constexpr int kPoints = 512;     // points per pack step (_NC)
constexpr int kCols = 48;        // 16 lo + 16 hi + 16 count columns
constexpr int kOutCols = 128;    // lane-padded output width
constexpr int kWords = 16;
constexpr int kThreads = 128;    // one warpgroup
constexpr int kTileRows = 64;    // wgmma's M
constexpr int kMTiles = kRows / kTileRows;
constexpr int kAcc = kTileRows * kCols / kThreads;   // 24 floats a thread
constexpr int kSplit = 8;        // blocks of a cluster that share K
static_assert(kSplit == 1 || kSplit == 2 || kSplit == 4 || kSplit == 8,
              "a block finishes whole 8-row groups of its M tile");

// The hit tile in shared memory: K-major with the 128-byte swizzle, as the
// TMA writes it: a row of 32 floats (one word) is one 128-byte line, 8
// lines a 1024-byte group.  P^T: one template in the plain core-matrix
// layout (8 rows x 16 bytes a core matrix), row e at 16 e, K chunk c of 4
// points kTemplateLead bytes on; word j's 48 x 32 slice is the template
// from row 15 - j on.  The same numbers are read by
// tests/test_torch_pack_probe_design.py.
constexpr unsigned kSwizzleBytes = 128;
constexpr unsigned kGroupBytes = 1024;    // hit descriptor SBO
constexpr unsigned kStepBytes = 32;       // 8 tf32 values: one wgmma K step
constexpr unsigned kLeadBytes = 16;       // hit descriptor LBO (unused when swizzled)
constexpr unsigned long long kLayoutSwizzle128 = 1;
constexpr int kTemplateRows = kCols + kWords - 1;         // 63
constexpr unsigned kTemplateLead = kTemplateRows * 16;    // P^T descriptor LBO
constexpr unsigned kTemplateStride = 8 * 16;              // P^T descriptor SBO
constexpr int kTemplateBytes = 8 * kTemplateLead;         // 32 points
constexpr int kBoxPoints = kSwizzleBytes / 4;             // 32: one word
constexpr int kBoxes = kPoints / kBoxPoints;              // 16
constexpr int kBoxBytes = kTileRows * kSwizzleBytes;      // 8 KB of hits
constexpr int kStepsPerBox = kSwizzleBytes / kStepBytes;  // 4
// partial sums a block receives: its 8 / kSplit groups of 8 rows from each
// block of the cluster, 12 floats a thread a group as 3 float4
constexpr int kSlotBytes = 8 * 3 * 32 * 16;


static_assert(kBoxBytes % kGroupBytes == 0, "boxes start on a swizzle group");

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// wgmma descriptors: start address, LBO and SBO in 16-byte units, layout.
__device__ __forceinline__ uint64_t hit_descriptor(unsigned addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | static_cast<uint64_t>(kLeadBytes >> 4) << 16
         | static_cast<uint64_t>(kGroupBytes >> 4) << 32
         | kLayoutSwizzle128 << 62;
}

__device__ __forceinline__ uint64_t pack_descriptor(unsigned addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | static_cast<uint64_t>(kTemplateLead >> 4) << 16
         | static_cast<uint64_t>(kTemplateStride >> 4) << 32;
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}

// Phase 0 of a barrier complete: its bytes have landed (acquire at cluster
// scope, as other blocks' stores complete some of them).
__device__ __forceinline__ bool mbar_try_wait(unsigned bar) {
  unsigned done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}"
      : "=r"(done) : "r"(bar), "r"(0u) : "memory");
  return done != 0;
}

// Wait for a barrier's bytes; bytes that never land trap instead of hanging.
__device__ __forceinline__ void mbar_wait(unsigned bar) {
  for (unsigned polls = 0; !mbar_try_wait(bar);)
    if (++polls == (1u << 22)) __trap();
}

__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void tma_load_box(unsigned dst, const CUtensorMap* map,
                                             unsigned bar, int point, int row) {
  mbar_expect(bar, kBoxBytes);
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(point), "r"(row)
      : "memory");
}

// Arrive on the cluster barrier without ordering memory: what the other
// blocks need before they write here (the barriers' init) is released by
// fence.mbarrier_init.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// The address of this block's shared-memory location `addr` in block `rank`
// of the cluster.
__device__ __forceinline__ unsigned in_block(unsigned addr, int rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ void proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Keeps the compiler from moving accesses of the accumulator across the
// wgmma fences.
__device__ __forceinline__ void fence_operands(float (&d)[kAcc]) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (64 x 48) += A (64 x 8, tf32) * B (8 x 48, tf32), both from shared
// memory through their descriptors.
__device__ __forceinline__ void wgmma_m64n48k8(float (&d)[kAcc], uint64_t a,
                                               uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
      "%24, %25, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ float pow2(int e) {
  return __int_as_float((127 + e) << 23);
}

struct Outputs {
  float* raw;          // pack: (256, 128) float32
  int* words[6];       // pack: words[0]; shift: v0..v5, (256, 128) int32 each
  const int* ints;     // shift: (256, 128) int32
  const int* count;    // shift: (16,) int32 shift counts
};

// Shared memory of a block: its hit boxes, the P^T template, the partial
// sums it receives (kSplit > 1), the barriers of the boxes and of the
// partial sums, and room to align the start to a swizzle group.
constexpr size_t kSmemBytes =
    static_cast<size_t>(kBoxes / kSplit) * (kBoxBytes + 8) + 8
    + kTemplateBytes + (kSplit > 1 ? kSlotBytes : 0) + kGroupBytes;

// The words of one 8-row group of the fragment (registers 4j + 2 half + e:
// row 16 w + lane / 4 + 8 half, column 8j + 2 (lane % 4) + e) through the
// pack probe's or the shift probe's epilogue.
template <bool SHIFT>
__device__ __forceinline__ void epilogue(const float (&acc)[kAcc], int half,
                                         int row, int q, const Outputs& out) {
  if constexpr (!SHIFT) {
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j)
      *reinterpret_cast<float2*>(out.raw + row * kOutCols + 8 * j + 2 * q) =
          make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
  }
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    // words k = 8a + 2q + e: low column k in register 4a + 2 half + e,
    // high column 16 + k eight registers on, count 32 + k sixteen on
    const int k = 8 * a + 2 * q;
    unsigned lo[2], hi[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      lo[e] = static_cast<unsigned>(static_cast<int>(acc[4 * a + 2 * half + e]));
      hi[e] = static_cast<unsigned>(
          static_cast<int>(acc[4 * (a + 2) + 2 * half + e]));
    }
    const int o = row * kOutCols + k;
    if constexpr (!SHIFT) {
      *reinterpret_cast<int2*>(out.words[0] + o) =
          make_int2(static_cast<int>(lo[0] | (hi[0] << 16)),
                    static_cast<int>(lo[1] | (hi[1] << 16)));
    } else {
      const int2 in = *reinterpret_cast<const int2*>(out.ints + o);
      const int2 s = *reinterpret_cast<const int2*>(out.count + k);
      const unsigned in_e[2] = {static_cast<unsigned>(in.x),
                                static_cast<unsigned>(in.y)};
      const int s_e[2] = {s.x, s.y};
      unsigned v[6][2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        v[0][e] = lo[e] | (hi[e] << 16);
        v[1][e] = lo[e] | (hi[e] * 65536u);
        v[2][e] = lo[e] + (hi[e] << 16);
        v[3][e] = lo[e] | ((hi[e] << 8) << 8);
        v[4][e] = in_e[e] << 16;
        v[5][e] = lo[e] | (hi[e] << (s_e[e] & 31));
      }
#pragma unroll
      for (int t = 0; t < 6; ++t)
        *reinterpret_cast<int2*>(out.words[t] + o) =
            make_int2(static_cast<int>(v[t][0]), static_cast<int>(v[t][1]));
    }
  }
}

template <bool SHIFT>
__global__ void __launch_bounds__(kThreads, 1)
probe_kernel(const __grid_constant__ CUtensorMap hit_map, Outputs out) {
  constexpr int kBlockBoxes = kBoxes / kSplit;
  constexpr int kOwned = 8 / kSplit;          // 8-row groups a block finishes
  extern __shared__ unsigned char smem_raw[];
  const unsigned raw_addr = smem_addr(smem_raw);
  unsigned char* s_hit =
      smem_raw + (((raw_addr + kGroupBytes - 1) & ~(kGroupBytes - 1)) - raw_addr);
  unsigned char* s_pack = s_hit + kBlockBoxes * kBoxBytes;
  float4* s_slot = reinterpret_cast<float4*>(s_pack + kTemplateBytes);
  unsigned long long* s_bar = reinterpret_cast<unsigned long long*>(
      reinterpret_cast<unsigned char*>(s_slot) + (kSplit > 1 ? kSlotBytes : 0));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rank = kSplit > 1 ? static_cast<int>(cluster_rank()) : 0;
  const int tile = blockIdx.x / kSplit;
  const int word0 = rank * kBlockBoxes;       // this block's first word of K
  const unsigned slot_bar = smem_addr(&s_bar[kBlockBoxes]);

  if (tid == 0) {
    for (int b = 0; b <= kBlockBoxes; ++b) mbar_init(smem_addr(&s_bar[b]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    proxy_fence();
    for (int b = 0; b < kBlockBoxes; ++b)
      tma_load_box(smem_addr(s_hit + b * kBoxBytes), &hit_map,
                   smem_addr(&s_bar[b]), (word0 + b) * kBoxPoints,
                   tile * kTileRows);
    // the partial sums this block will receive from the other blocks
    if constexpr (kSplit > 1)
      mbar_expect(slot_bar, (kSplit - 1) * kOwned * 3 * 32 * 16);
  }
  // the P^T template from the rule: row e is row e - 15 of word 0's slice
  // (the low half-word at 0, the high at 16, the count at 32)
  for (int c = tid; c < kTemplateRows * 8; c += kThreads) {
    const int ch = c / kTemplateRows, e = c - ch * kTemplateRows, t = e - 15;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const int x = (ch & 3) * 4;
    if ((t == 0 && ch < 4) || (t == 16 && ch >= 4))
      v = make_float4(pow2(x), pow2(x + 1), pow2(x + 2), pow2(x + 3));
    else if (t == 32)
      v = make_float4(1.0f, 1.0f, 1.0f, 1.0f);
    *reinterpret_cast<float4*>(s_pack + ch * kTemplateLead + 16 * e) = v;
  }
  proxy_fence();
  __syncthreads();
  // every block of the cluster runs, its barriers armed, before any block
  // writes into another
  if constexpr (kSplit > 1) cluster_arrive_relaxed();

  // the zero padding of this block's share of the tile's rows, while the
  // boxes are in flight
  {
    constexpr int kShare = kTileRows / kSplit;
    const int row0 = tile * kTileRows + rank * kShare;
    constexpr int kWordPad = (kOutCols - kWords) / 4;     // int4s a row
    constexpr int kRawPad = (kOutCols - kCols) / 4;
    const int4 zero = make_int4(0, 0, 0, 0);
#pragma unroll
    for (int t = 0; t < (SHIFT ? 6 : 1); ++t)
      for (int i = tid; i < kShare * kWordPad; i += kThreads)
        *reinterpret_cast<int4*>(out.words[t] + (row0 + i / kWordPad) * kOutCols
                                 + kWords + (i % kWordPad) * 4) = zero;
    if constexpr (!SHIFT) {
      for (int i = tid; i < kShare * kRawPad; i += kThreads)
        *reinterpret_cast<int4*>(out.raw + (row0 + i / kRawPad) * kOutCols
                                 + kCols + (i % kRawPad) * 4) = zero;
    }
  }

  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;
  fence_operands(acc);
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
  for (int b = 0; b < kBlockBoxes; ++b) {
    mbar_wait(smem_addr(&s_bar[b]));
    const unsigned a = smem_addr(s_hit + b * kBoxBytes);
    const unsigned p = smem_addr(s_pack) + 16 * (15 - (word0 + b));
#pragma unroll
    for (int s = 0; s < kStepsPerBox; ++s)
      wgmma_m64n48k8(acc, hit_descriptor(a + s * kStepBytes),
                     pack_descriptor(p + s * 2 * kTemplateLead));
  }
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  fence_operands(acc);

  // 8-row group g = 2 warp + half is finished by block g / kOwned of the
  // cluster; the others send it their partial sums of it with st.async,
  // each store completing its bytes on the owner's barrier
  if constexpr (kSplit > 1) {
    cluster_wait();
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int g = 2 * warp + half, owner = g / kOwned;
      if (owner == rank) continue;
      const unsigned slot = in_block(smem_addr(
          &s_slot[((rank * kOwned + g % kOwned) * 3) * 32 + lane]), owner);
      const unsigned bar = in_block(slot_bar, owner);
#pragma unroll
      for (int m = 0; m < 3; ++m)
        asm volatile(
            "st.async.weak.shared::cluster.mbarrier::complete_tx::bytes"
            ".v4.f32 [%0], {%1, %2, %3, %4}, [%5];"
            :: "r"(slot + m * 32 * 16), "f"(acc[8 * m + 2 * half]),
               "f"(acc[8 * m + 2 * half + 1]), "f"(acc[8 * m + 4 + 2 * half]),
               "f"(acc[8 * m + 4 + 2 * half + 1]), "r"(bar)
            : "memory");
    }
  }

  const int q = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int g = 2 * warp + half;
    if (g / kOwned != rank) continue;
    if constexpr (kSplit > 1) {
      mbar_wait(slot_bar);
#pragma unroll
      for (int from = 0; from < kSplit; ++from) {
        if (from == rank) continue;
        const float4* x = &s_slot[((from * kOwned + g % kOwned) * 3) * 32 + lane];
#pragma unroll
        for (int m = 0; m < 3; ++m) {
          const float4 v = x[m * 32];
          acc[8 * m + 2 * half] += v.x;
          acc[8 * m + 2 * half + 1] += v.y;
          acc[8 * m + 4 + 2 * half] += v.z;
          acc[8 * m + 4 + 2 * half + 1] += v.w;
        }
      }
    }
    epilogue<SHIFT>(acc, half,
                    tile * kTileRows + 16 * warp + (lane >> 2) + 8 * half, q,
                    out);
  }
}

__global__ void probe_empty_kernel() {}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// The tensor map of a (256, 512) float32 hit tile at `hit`: boxes of 64
// rows x 32 points with the 128-byte swizzle.  The last one is kept per
// host thread (the map holds nothing but the address and fixed shapes).
cudaError_t hit_map(const void* hit, CUtensorMap* map) {
  thread_local CUtensorMap cached;
  thread_local const void* cached_for = nullptr;
  if (hit != cached_for) {
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return cudaErrorNotSupported;
    const cuuint64_t dims[2] = {kPoints, kRows};
    const cuuint64_t strides[1] = {kPoints * sizeof(float)};
    const cuuint32_t box[2] = {kBoxPoints, kTileRows};
    const cuuint32_t elem[2] = {1, 1};
    const CUresult r = encode(
        &cached, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(hit),
        dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) {
      cached_for = nullptr;
      return cudaErrorInvalidValue;
    }
    cached_for = hit;
  }
  *map = cached;
  return cudaSuccess;
}

cudaLaunchConfig_t config(int blocks, int cluster, size_t smem,
                          cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  return cfg;
}

// The cards a process may launch on; a card numbered at or above it is
// refused.
constexpr int kMaxCards = 64;

// `ask()` once per card, for the current card, and its answer kept per
// card: cudaFuncSetAttribute acts on the current card's context, so an
// attribute set for one card is not set for the next.  call_once makes
// host threads launching at once ask each card once.
struct PerCard {
  std::once_flag once[kMaxCards];
  cudaError_t answer[kMaxCards];

  template <typename Ask>
  cudaError_t get(Ask ask) {
    int card = 0;
    const cudaError_t err = cudaGetDevice(&card);
    if (err != cudaSuccess) return err;
    if (card < 0 || card >= kMaxCards) return cudaErrorInvalidDevice;
    std::call_once(once[card], [&] { answer[card] = ask(); });
    return answer[card];
  }
};

template <bool SHIFT>
int launch(const void* hit, const Outputs& out, void* stream) {
  auto kernel = probe_kernel<SHIFT>;
  static PerCard sized;                       // asked once per card
  cudaError_t err = sized.get([&] {
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(kSmemBytes));
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap map;
  err = hit_map(hit, &map);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      config(kMTiles * kSplit, kSplit, kSmemBytes,
             static_cast<cudaStream_t>(stream), attr);
  err = cudaLaunchKernelEx(&cfg, kernel, map, out);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// hit (256, 512) float32 -> raw (256, 128) float32, word (256, 128) int32.
int pack_probe_launch(const void* hit, void* raw, void* word, void* stream) {
  Outputs out = {};
  out.raw = static_cast<float*>(raw);
  out.words[0] = static_cast<int*>(word);
  return launch<false>(hit, out, stream);
}

// hit (256, 512) float32, ints (256, 128) int32, shift_count (16,) int32
// -> six (256, 128) int32 outputs, contiguous in `out` (6, 256, 128).
int shift_probe_launch(const void* hit, const void* ints,
                       const void* shift_count, void* out, void* stream) {
  Outputs o = {};
  for (int t = 0; t < 6; ++t)
    o.words[t] = static_cast<int*>(out) + t * kRows * kOutCols;
  o.ints = static_cast<const int*>(ints);
  o.count = static_cast<const int*>(shift_count);
  return launch<true>(hit, o, stream);
}

// An empty kernel on `blocks` blocks of 128 threads in clusters of
// `cluster`: the floor under a one-launch kernel of this size.
int probe_empty_launch(int blocks, int cluster, void* stream) {
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(
      blocks, cluster, 0, static_cast<cudaStream_t>(stream), attr);
  const cudaError_t err = cudaLaunchKernelExC(
      &cfg, reinterpret_cast<const void*>(probe_empty_kernel), nullptr);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

int pack_probe_rows() { return kRows; }
int pack_probe_points() { return kPoints; }
int pack_probe_split() { return kSplit; }

}  // extern "C"
