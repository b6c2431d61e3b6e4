// Exact ball query for Hopper (sm_90a): hit bitmask pack, and first-k.
//
// Replaces the TPU kernel scan2cap_tpu/ops/pallas/ballquery.py
// (_bq_pack_kernel :58, launched by ball_query_pack_pallas :120) together
// with the XLA slot decode it feeds (scan2cap_tpu/ops/grouping.py:135-233).
// Two entry points share one tile-and-chunk routine (bq_kernel):
//   * ball_query_pack: the Pallas kernel's (words, counts) contract — bit i
//     of word w is the hit test of point 32w+i, counts are per-word
//     popcounts;
//   * ball_query: first-k in scan order with the reference's padding
//     (ball_query_gpu.cu:9-54): the first nsample points with d2 < r2, the
//     remaining slots repeat the first hit, a query with no hit is all
//     zeros.  This is the main-path ball query.
// The hit test is d2 < r2 in f32 with dx = query - point, and d2 rounded
// as XLA rounds dx*dx + dy*dy + dz*dz on the CPU:
// fma(dz, dz, fma(dx, dx, dy*dy)), written out with __fmaf_rn/__fmul_rn so
// nvcc cannot contract it another way (a point lying exactly on the radius
// is in or out by that rounding; the plain PyTorch version computes the
// same FMAs, ops/distance.py).  r2 is the host's double radius**2 rounded
// once to f32, the value JAX compares against.
//
// What bounds it on the H100: issue slots.  An exact all-pairs test costs
// 8 instructions per 32 pairs (3 subtractions, a product, 2 FMAs, the
// compare, the ballot); the first site tests up to B*2048*40,000 pairs,
// which is 0.039 ms of the card's issue rate at 1,980 MHz, while the bytes
// are small (a 480 KB scene stays in L2).  A kernel that gives every query
// its own pass over the scene is bound by the loads instead: three 12-byte
// stride loads per 32 pairs, about ten L1 wavefronts, with nothing reused.
// The fused form stops a query once it holds nsample hits, so its work
// depends on where the hits lie.
//
// Design: a block owns a tile of queries and streams the scene through
// shared memory, so a point comes from L2 once per tile and is read from
// shared memory once per Q queries.
//   * A warp keeps Q queries in registers; its 32 lanes test 32 consecutive
//     points per step against all Q, and __ballot_sync of the 32 hit bits
//     is exactly the TPU kernel's packed word.  Three shared-memory reads
//     serve Q hit tests.  A warp takes 4 steps at a time, so that 4 Q
//     independent distance chains and ballots are in flight.
//   * Points lie in shared memory as they lie in device memory (x, y, z of
//     a point side by side): lane l reads words 3l, 3l+1, 3l+2, and 3 is
//     coprime with the 32 banks, so no read conflicts and nothing is
//     transposed.  A chunk of C points is copied with cp.async while the
//     chunk before it is tested (two buffers, one barrier per chunk).  The
//     16-byte copies need an aligned source, and a scene starts at any
//     multiple of 4 bytes (b*N*12 past a base that may be a view), so the
//     chunk is stored as many floats into its buffer as its source lies
//     past a 16-byte boundary: source and destination are then aligned
//     together, the few floats before the first boundary and after the last
//     go by 4-byte copies, and lane l reads at that offset (copy_chunk).
//     Points past the end of a range test as "no hit" by index, never by a
//     sentinel value.
//   * The first site has only B*M = 4,096 queries, too few warps for 528
//     schedulers at Q queries a warp.  So a block of G*R warps takes G*Q
//     queries and splits the scene into R contiguous ranges of whole words:
//     warp (g, r) tests queries g*Q..g*Q+Q-1 against range r.
//   * First-k: a warp ranks each hit by popcount of the lower lanes' bits
//     and writes it into the query's list for its range in shared memory
//     (at most nsample per range); a query that holds nsample hits of its
//     range moves to infinity, where it hits nothing more, a warp stops
//     testing when all its queries are full, and the block leaves the scan
//     when all warps have.  A step looks at its hits only if one of its Q
//     words is not zero.  Then the block
//     concatenates the ranges' lists in range order, keeps the first
//     nsample, pads with the first hit of the first range that has one
//     (zeros when none has) and stores each row with coalesced writes.
//     Contiguous ranges make the merge a concatenation.  Nothing of the
//     (M, N) hit matrix is ever stored.
//   * Pack: no early exit and no lists; lane k keeps word k of a 32-word
//     run per query, and the run goes out with one coalesced write per
//     query for the words and one for the counts.
//
// Variants (Q, G, R, C) are instantiated from one template below; which one
// a call gets is decided by kernels/ballquery.py (bq_variant) from the
// shape: no variant is a fallback of another.  On the flagship's main path
// N = 40,000 gets 8 x 2 x 4 x 512 (16 queries and 8 warps a block) and the
// small sites (N <= 2,048) get 4 x 2 x 4 x 512.  Shared memory: 2 R (3C + 4)
// floats of points plus, for the first-k, G Q R (nsample + 1) ints of
// lists and their counts.  Every variant holds the lists of nsample up to
// 256 there; above that (LISTS_IN_SHARED false) the lists live in a
// workspace in device memory, G Q R nsample ints a block, written by the
// scan and read by the merge after the block's barrier, which orders
// global memory as it does shared.  Hits are rare writes and the merge
// reads each list once, so this costs little beside the scan; it lifts the
// bound on nsample to what device memory holds.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kMaxSharedBytes = 232448;    // what a block can use on sm_90
constexpr int kUnroll = 4;                    // steps tested at a time

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Floats by which `src` lies past a 16-byte boundary (0..3).
__device__ __forceinline__ int floats_past_16(const float* src) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 2) & 3u);
}

// Copy `nf` floats from `src` to `buf + floats_past_16(src)` with the
// THREADS threads t = 0..THREADS-1: 4-byte copies up to the source's first
// 16-byte boundary, 16-byte copies from there, 4-byte copies for what is
// left.  `buf` is 16-byte aligned, so every 16-byte copy is aligned on both
// sides.  kernels/ballquery.py copy_plan is the same split.
template <int THREADS>
__device__ __forceinline__ void copy_chunk(float* buf, const float* src,
                                           int nf, int t) {
  const int mis = floats_past_16(src);
  float* dst = buf + mis;
  const int head = min(nf, (4 - mis) & 3);
  const int body = (nf - head) >> 2;
  const int tail = nf - head - 4 * body;
  for (int i = t; i < body; i += THREADS)
    cp_async_16(dst + head + 4 * i, src + head + 4 * i);
  if (t < head) cp_async_4(dst + t, src + t);
  if (t < tail)
    cp_async_4(dst + head + 4 * body + t, src + head + 4 * body + t);
}

// Q queries a warp, G warps of queries and R ranges of the scene a block,
// C points a chunk.  Grid: (ceil(M / (G*Q)), B).  The first-k's lists lie
// in shared memory, or with LISTS_IN_SHARED false in `lists`.
template <int Q, int G, int R, int C, bool PACK, bool LISTS_IN_SHARED>
__device__ __forceinline__ void bq_body(
    const float* __restrict__ xyz, const float* __restrict__ new_xyz, int n,
    int m, float r2, int nsample, int* __restrict__ idx,
    unsigned* __restrict__ words, int* __restrict__ counts,
    int* __restrict__ lists) {
  static_assert(C % 32 == 0 && C >= 32, "a chunk is whole words");
  constexpr int kTile = G * Q;              // queries of a block
  constexpr int kBuf = 3 * C + 4;           // floats of one chunk buffer
  constexpr int U = kUnroll;
  static_assert((C / 32) % U == 0 && 32 % U == 0,
                "U steps never straddle a chunk or a 32-word run");
  const float kNowhere = __int_as_float(0x7f800000);   // +inf
  extern __shared__ float4 s_raw[];
  float* s_pts = reinterpret_cast<float*>(s_raw);            // [R][2][kBuf]
  int* s_cnt = reinterpret_cast<int*>(s_pts + R * 2 * kBuf);  // [kTile][R]
  int* s_list;                                     // [kTile][R][nsample]
  if constexpr (LISTS_IN_SHARED)
    s_list = s_cnt + kTile * R;
  else
    s_list = lists + (static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x)
                         * kTile * R * nsample;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = warp % G;                   // which Q queries of the tile
  const int r = warp / G;                   // which range of the scene
  const int b = blockIdx.y;
  const float* p = xyz + static_cast<size_t>(b) * n * 3;
  const int q0 = blockIdx.x * kTile + g * Q;
  const unsigned lower = (1u << lane) - 1u;

  float qx[Q], qy[Q], qz[Q];
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    qx[k] = kNowhere;                       // a query past M finds nothing
    qy[k] = qz[k] = 0.0f;
    if (q0 + k < m) {
      const float* q = new_xyz + (static_cast<size_t>(b) * m + q0 + k) * 3;
      qx[k] = __ldg(q);
      qy[k] = __ldg(q + 1);
      qz[k] = __ldg(q + 2);
    }
  }

  // ranges of whole words; the last ones may be short or empty
  const int nwords = (n + 31) >> 5;
  const int range_words = (nwords + R - 1) / R;
  const int range_points = range_words * 32;
  const int rs = min(r * range_points, n);
  const int re = min(rs + range_points, n);
  const int nchunks = (range_points + C - 1) / C;   // the same for every warp
  float* bufs = s_pts + r * 2 * kBuf;
  const int t = g * 32 + lane;              // thread among the range's G warps

  int cnt[Q];                               // hits of this range, per query
  unsigned mine[Q];                         // pack: lane k holds word k of a run
  bool done = re <= rs;
  if constexpr (!PACK) {
    bool full = true;
#pragma unroll
    for (int k = 0; k < Q; ++k) {
      cnt[k] = q0 + k < m ? 0 : nsample;    // a query past M has nothing to find
      full = full && cnt[k] >= nsample;
    }
    done = done || full;
  } else {
#pragma unroll
    for (int k = 0; k < Q; ++k) mine[k] = 0u;
  }

  if (re > rs)
    copy_chunk<G * 32>(bufs, p + 3 * static_cast<size_t>(rs),
                       3 * (min(rs + C, re) - rs), t);
  for (int c = 0; c < nchunks; ++c) {
    // chunk c has landed for every thread, and every thread is through
    // chunk c-1, whose buffer the next copy overwrites
    cp_async_wait_all();
    if constexpr (PACK) {
      __syncthreads();
    } else {
      if (__syncthreads_and(done)) break;
    }
    const int ps = rs + c * C;
    const int pe = min(ps + C, re);
    if (ps + C < re)
      copy_chunk<G * 32>(bufs + ((c + 1) & 1) * kBuf,
                         p + 3 * static_cast<size_t>(ps + C),
                         3 * (min(ps + 2 * C, re) - (ps + C)), t);
    if (pe <= ps || (!PACK && done)) continue;      // uniform in the warp

    const float* pts = bufs + (c & 1) * kBuf
                       + floats_past_16(p + 3 * static_cast<size_t>(ps))
                       + 3 * lane;
    const int steps = (pe - ps + 31) >> 5;
    // U steps at a time: their 3 U reads, U Q distances and U Q ballots
    // are independent, which is what hides the latency of each
    for (int s0 = 0; s0 < steps; s0 += U) {
      float px[U], py[U], pz[U];
      bool in[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {         // a step past the chunk's last
        px[u] = pts[96 * (s0 + u)];         // reads inside the buffer and
        py[u] = pts[96 * (s0 + u) + 1];     // tests "no hit"
        pz[u] = pts[96 * (s0 + u) + 2];
        in[u] = ps + (s0 + u) * 32 + lane < pe;   // by index: no sentinel
      }
      unsigned w[U][Q];
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int k = 0; k < Q; ++k) {
          const float dx = __fsub_rn(qx[k], px[u]);
          const float dy = __fsub_rn(qy[k], py[u]);
          const float dz = __fsub_rn(qz[k], pz[u]);
          const float d2 =
              __fmaf_rn(dz, dz, __fmaf_rn(dx, dx, __fmul_rn(dy, dy)));
          w[u][k] = __ballot_sync(kFull, in[u] && d2 < r2);
        }
      }
      if constexpr (PACK) {
        // U divides 32 and the steps of a chunk: the U words lie in one run
        const int word = c * (C / 32) + s0;       // first word, of the range
        const int k32 = word & 31;                // its place in the run
        const int last = k32 + min(U, steps - s0) - 1;   // last word's place
#pragma unroll
        for (int u = 0; u < U; ++u) {
#pragma unroll
          for (int k = 0; k < Q; ++k)
            if (lane == k32 + u) mine[k] = w[u][k];
        }
        if (last == 31 || ps + (s0 + U) * 32 >= re) {    // run or range ends
          const size_t first = static_cast<size_t>(r) * range_words
                               + (word - k32) + lane;
#pragma unroll
          for (int k = 0; k < Q; ++k) {
            if (q0 + k < m && lane <= last) {
              const size_t o =
                  (static_cast<size_t>(b) * m + q0 + k) * nwords + first;
              words[o] = mine[k];
              counts[o] = __popc(mine[k]);
            }
          }
        }
      } else {
        // hits are rare: one test for the U steps, one per step, and only
        // then one per query
        unsigned some[U];
        unsigned any = 0u;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          some[u] = 0u;
#pragma unroll
          for (int k = 0; k < Q; ++k) some[u] |= w[u][k];
          any |= some[u];
        }
        if (any != 0u) {
#pragma unroll
          for (int u = 0; u < U; ++u) {           // in scan order
            if (some[u] == 0u) continue;
            const int j = ps + (s0 + u) * 32 + lane;
#pragma unroll
            for (int k = 0; k < Q; ++k) {
              const unsigned wk = w[u][k];
              if (wk == 0u) continue;
              const int rank = cnt[k] + __popc(wk & lower);
              if (((wk >> lane) & 1u) && rank < nsample)
                s_list[((g * Q + k) * R + r) * nsample + rank] = j;
              cnt[k] += __popc(wk);
              // a full query tests no more: nothing is below r2 from there
              if (cnt[k] >= nsample) qx[k] = kNowhere;
            }
          }
        }
      }
    }
    if constexpr (!PACK) {
      bool full = true;
#pragma unroll
      for (int k = 0; k < Q; ++k) full = full && cnt[k] >= nsample;
      done = full;
    }
  }
  if constexpr (!PACK) {
    // -- first-k: concatenate the ranges' lists in range order
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < Q; ++k)
        s_cnt[(g * Q + k) * R + r] = min(cnt[k], nsample);
    }
    __syncthreads();
    for (int i = warp; i < kTile; i += G * R) {
      const int qi = blockIdx.x * kTile + i;
      if (qi >= m) break;
      const int* c = s_cnt + i * R;
      const int* l = s_list + i * R * nsample;
      int first = 0;                 // the first hit; 0 when no range has one
#pragma unroll
      for (int rr = R - 1; rr >= 0; --rr)
        if (c[rr] > 0) first = l[rr * nsample];
      int* orow = idx + (static_cast<size_t>(b) * m + qi) * nsample;
      for (int s = lane; s < nsample; s += 32) {
        int v = first;
        int off = 0;
#pragma unroll
        for (int rr = 0; rr < R; ++rr) {
          const int cc = c[rr];
          if (s >= off && s < off + cc) v = l[rr * nsample + s - off];
          off += cc;
        }
        orow[s] = v;
      }
    }
  }
}

// The pack and the first-k with its lists in shared memory.
template <int Q, int G, int R, int C, bool PACK>
__global__ void __launch_bounds__(G * R * 32)
bq_kernel(const float* __restrict__ xyz, const float* __restrict__ new_xyz,
          int n, int m, float r2, int nsample, int* __restrict__ idx,
          unsigned* __restrict__ words, int* __restrict__ counts,
          int* __restrict__ lists) {
  bq_body<Q, G, R, C, PACK, true>(xyz, new_xyz, n, m, r2, nsample, idx,
                                  words, counts, lists);
}

// The first-k with its lists in device memory (nsample above 256).
template <int Q, int G, int R, int C>
__global__ void __launch_bounds__(G * R * 32)
bq_lists_kernel(const float* __restrict__ xyz,
                const float* __restrict__ new_xyz, int n, int m, float r2,
                int nsample, int* __restrict__ idx,
                unsigned* __restrict__ words, int* __restrict__ counts,
                int* __restrict__ lists) {
  bq_body<Q, G, R, C, false, false>(xyz, new_xyz, n, m, r2, nsample, idx,
                                    words, counts, lists);
}

using Launcher = cudaError_t (*)(const float*, const float*, int, int, int,
                                 float, int, int*, unsigned*, int*, int*,
                                 cudaStream_t);

template <int Q, int G, int R, int C, bool PACK, bool LISTS_IN_SHARED = true>
cudaError_t launch(const float* xyz, const float* new_xyz, int batch, int n,
                   int m, float r2, int nsample, int* idx, unsigned* words,
                   int* counts, int* lists, cudaStream_t stream) {
  auto kernel = [] {
    if constexpr (LISTS_IN_SHARED) return bq_kernel<Q, G, R, C, PACK>;
    else return bq_lists_kernel<Q, G, R, C>;
  }();
  size_t smem = static_cast<size_t>(R) * 2 * (3 * C + 4) * sizeof(float);
  if constexpr (!PACK)
    smem += static_cast<size_t>(G) * Q * R
            * ((LISTS_IN_SHARED ? nsample : 0) + 1) * sizeof(int);
  if (!LISTS_IN_SHARED && lists == nullptr) return cudaErrorInvalidValue;
  if (smem > kMaxSharedBytes || batch > 65535) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((m + G * Q - 1) / (G * Q)),
                  static_cast<unsigned>(batch));
  kernel<<<grid, G * R * 32, smem, stream>>>(xyz, new_xyz, n, m, r2, nsample,
                                             idx, words, counts, lists);
  return cudaGetLastError();
}

struct Variant {
  int queries, groups, ranges, chunk;
  Launcher first_k, pack, first_k_lists_in_memory;
};

#define BQ_VARIANT(q, g, r, c)                                      \
  {q, g, r, c, &launch<q, g, r, c, false>, &launch<q, g, r, c, true>, \
   &launch<q, g, r, c, false, false>}
// The same list, in the same order, as VARIANTS of kernels/ballquery.py.
const Variant kVariants[] = {
    BQ_VARIANT(8, 2, 4, 512), BQ_VARIANT(8, 4, 4, 512),
    BQ_VARIANT(8, 2, 8, 256), BQ_VARIANT(8, 1, 8, 256),
    BQ_VARIANT(8, 1, 4, 512), BQ_VARIANT(8, 1, 4, 256),
    BQ_VARIANT(4, 4, 4, 512), BQ_VARIANT(4, 2, 8, 256),
    BQ_VARIANT(4, 4, 8, 256), BQ_VARIANT(4, 2, 4, 512),
    BQ_VARIANT(4, 2, 2, 512), BQ_VARIANT(4, 1, 4, 512),
    BQ_VARIANT(2, 2, 4, 512), BQ_VARIANT(4, 2, 1, 2048),
};
#undef BQ_VARIANT
constexpr int kNumVariants = sizeof(kVariants) / sizeof(kVariants[0]);

}  // namespace

extern "C" {

int bq_num_variants() { return kNumVariants; }

// (queries per warp, query warps, ranges, chunk points) of variant `v`.
int bq_variant_info(int v, int* queries, int* groups, int* ranges,
                    int* chunk) {
  if (v < 0 || v >= kNumVariants) return 1;
  *queries = kVariants[v].queries;
  *groups = kVariants[v].groups;
  *ranges = kVariants[v].ranges;
  *chunk = kVariants[v].chunk;
  return 0;
}

// xyz (B, N, 3), new_xyz (B, M, 3) float32 contiguous on the device, at any
// 4-byte alignment; words (B, M, W) uint32 and counts (B, M, W) int32 with
// W = ceil(N / 32).  `variant` indexes the list above.  Returns the
// launch's cudaError_t (0 on success); a refused launch is an error, no
// other kernel is tried.
int ball_query_pack_launch(const float* xyz, const float* new_xyz, int batch,
                           int n, int m, float r2, unsigned* words,
                           int* counts, int variant, void* stream) {
  if (variant < 0 || variant >= kNumVariants || n < 1)
    return cudaErrorInvalidValue;
  if (batch * m == 0) return 0;
  return static_cast<int>(kVariants[variant].pack(
      xyz, new_xyz, batch, n, m, r2, 0, nullptr, words, counts, nullptr,
      static_cast<cudaStream_t>(stream)));
}

// Same inputs; idx (B, M, nsample) int32, every slot written.  `lists`
// null keeps the hit lists in shared memory; otherwise it is a workspace of
// B * ceil(M / (G*Q)) * G*Q * R * nsample ints on the device, where they go.
int ball_query_launch(const float* xyz, const float* new_xyz, int batch, int n,
                      int m, float r2, int nsample, int* idx, int variant,
                      int* lists, void* stream) {
  if (variant < 0 || variant >= kNumVariants || n < 1 || nsample < 1)
    return cudaErrorInvalidValue;
  if (batch * m == 0) return 0;
  const Variant& v = kVariants[variant];
  return static_cast<int>((lists ? v.first_k_lists_in_memory : v.first_k)(
      xyz, new_xyz, batch, n, m, r2, nsample, idx, nullptr, nullptr, lists,
      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
