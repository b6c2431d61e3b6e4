// Iterative furthest-point sampling for Hopper (sm_90a).
//
// Replaces the TPU kernel scan2cap_tpu/ops/pallas/fps.py
// (_fps_kernel :117, launched by furthest_point_sample_pallas :288), with
// the same semantics as the reference's sampling_gpu.cu:69-173:
//   * the first pick is index 0;
//   * a running min of squared distances is kept per point; points with
//     |p|^2 <= 1e-3 (zero padding) start below every distance instead of
//     at 1e10, so they never win; an all-invalid scene therefore returns
//     all zeros;
//   * each step takes the argmax of the running min, ties to the lowest
//     index;
//   * distances are the f32 coordinate-difference form with the rounding
//     XLA gives jnp.sum((x - last)**2, -1) on the CPU:
//     fma(dz, dz, fma(dy, dy, dx*dx)), written out with __fmaf_rn and
//     __fmul_rn so nvcc cannot contract it another way (the plain PyTorch
//     version computes the same FMAs, ops/distance.py); the |p|^2 validity
//     test uses the same form.
//
// What bounds it on the H100: the chain of npoint dependent steps.  The
// arithmetic (about 9 flops per point per step) is far below the card's
// rate; what a step costs is one pass over the scene's state plus an argmax
// across everything that holds a part of it.  The first version of this
// kernel kept only the running min on chip (one 1024-thread block per
// scene) and read x/y/z of all points again each step: 480 KB per step at
// 40,000 points through one SM's path to L2, which is what its 8 us per
// step on an H100 were.  It was bound by one SM's L2 bandwidth, not by
// latency alone.
//
// Design: all of a scene's state stays on chip for all steps.
//   * Every thread owns P points and keeps their x, y, z and running min in
//     registers (arrays indexed by unrolled constants only).  The step's
//     inner loop touches no memory.
//   * A scene is spread over CS thread blocks of T threads: CS = 1 for the
//     small sites, a thread-block cluster of CS = 8 blocks on neighbouring
//     SMs where one SM's registers do not hold the scene (40,000 points x
//     16 bytes = 640 KB).  Point j belongs to slot j / (CS*T) of global
//     thread j % (CS*T): loads are coalesced, every block gets the same
//     share of a padded scene, and a thread scans its slots in ascending
//     index order.
//   * The running min is held as its float's bit pattern in a signed int:
//     distances are >= +0, where the int order is the float order; zero
//     padding is -1 and an unused register slot -2, and the integer min
//     min(key, bits(d2)) leaves both where they are.  That lets the warp
//     argmax be two redux.sync instructions (max of the keys, then min of
//     the indices that hold it: ties to the lowest index) in place of ten
//     shuffles.
//   * Block argmax: lane 0 of each warp writes (key, index) to a slot of
//     shared memory, one __syncthreads, then every warp reduces the slots
//     itself.  The slots are double-buffered by the step's parity, so one
//     barrier per step is enough.
//   * Cluster argmax: the block's winner travels with its coordinates.
//     Lanes 0..CS-1 of warp 0 send (key, index, x, y, z) into this block's
//     slot in every block of the cluster (distributed shared memory) with
//     st.async, which counts the bytes it delivers on a transaction barrier
//     (mbarrier) in the receiving block.  A block waits on its own barrier
//     until all CS candidates have landed, then every warp reduces them
//     itself, so all blocks agree on the pick without a second round and
//     without a barrier of the whole cluster: the exchange costs one
//     remote store's latency.  Slots and barriers are double-buffered by
//     the step's parity: a block cannot send step k+2's candidate before
//     it has every block's candidate of step k+1, which a block sends only
//     after all its threads are through step k's wait (the __syncthreads
//     of the block argmax stands between).  Block 0 writes out[k].
//   * The coordinates of the pick never come from global memory: each block
//     keeps a copy of its points in shared memory (16 bytes a point), read
//     once per step at the winner's slot, because a register array cannot
//     be indexed by a run-time slot number.
//
// Variants (CS, T, P) are instantiated from one template below; which one a
// scene gets is a function of N alone, made by kernels/fps.py
// (fps_variant): no variant is a fallback of another.  On the flagship's
// main path N = 512 gets 1 x 128 x 4, N = 1024 gets 1 x 256 x 4, N = 2048
// gets 1 x 512 x 4 and N = 40000 gets 8 x 256 x 20: few warps with many
// points each, because the argmax across warps costs more than the
// arithmetic.  The largest scene in registers is 81,920 points (8 blocks x
// 256 threads x 40 points: 160 registers of state per thread); what sets it
// is the register file, then 16 bytes a point of shared memory (160 KB of
// 227 KB there).  Above that, 8 x 1024 x 0 streams the scene from a
// workspace in device memory (fps_stream_kernel): no limit but the
// device's memory.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kPadding = -1;   // zero padding: below every distance
constexpr int kUnused = -2;    // register slot beyond N: below the padding

__device__ __forceinline__ float sq_dist(float ax, float ay, float az,
                                         float bx, float by, float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fmaf_rn(dz, dz, __fmaf_rn(dy, dy, __fmul_rn(dx, dx)));
}

// (key, index) argmax over a warp, the result in every lane: the larger key
// wins, equal keys go to the smaller index.
__device__ __forceinline__ void warp_arg_max(int& key, int& idx) {
  const int top = __reduce_max_sync(kFull, key);
  idx = __reduce_min_sync(kFull, key == top ? idx : INT_MAX);
  key = top;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The address of this block's shared-memory location `addr` in block `rank`
// of the cluster.
__device__ __forceinline__ unsigned in_block(unsigned addr, unsigned rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ bool mbar_try_wait(unsigned bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Bytes of one candidate: (key, index, x, y) and z.
constexpr unsigned kCandidateBytes = 20;

// Shared state of the exchange between the blocks of a cluster: each
// block's candidate (key, index, x, y) and z, double-buffered by the step's
// parity, and the transaction barriers they land on.
template <int CS>
struct Exchange {
  int4 cand[2][CS];
  int cand_z[2][CS];
  unsigned long long bar[2];
};

// Arm both barriers (one arrival and CS candidates each); called by one
// thread before the block's first __syncthreads.
template <int CS>
__device__ __forceinline__ void exchange_init(Exchange<CS>& x) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
               :: "r"(smem_addr(&x.bar[0])) : "memory");
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
               :: "r"(smem_addr(&x.bar[1])) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  mbar_expect(smem_addr(&x.bar[0]), CS * kCandidateBytes);
  mbar_expect(smem_addr(&x.bar[1]), CS * kCandidateBytes);
}

// Step k's pick of the whole cluster from each block's winner (best, pick),
// one of the block's own points, whose coordinates coords(pick) returns
// (called by the sending lanes only).  Lanes 0..CS-1 of warp 0 send the
// candidate into this block's slot in every block of the cluster with
// st.async onto the receiver's barrier; every block waits for all CS
// candidates, and every warp reduces them itself.  Returns the pick and
// sets (lx, ly, lz) to its coordinates.
template <int CS, int TT, int T, typename Coords>
__device__ __forceinline__ int cluster_pick(Exchange<CS>& x, int k, int rank,
                                            int warp, int lane, int tid,
                                            int best, int pick, Coords coords,
                                            float& lx, float& ly, float& lz) {
  const int par = k & 1;
  if (warp == 0 && lane < CS) {      // lane r sends to block r
    const float3 w = coords(pick);
    const unsigned bar = in_block(smem_addr(&x.bar[par]), lane);
    asm volatile(
        "st.async.weak.shared::cluster.mbarrier::complete_tx::bytes"
        ".v4.b32 [%0], {%1, %2, %3, %4}, [%5];"
        :: "r"(in_block(smem_addr(&x.cand[par][rank]), lane)),
           "r"(best), "r"(pick), "r"(__float_as_int(w.x)),
           "r"(__float_as_int(w.y)), "r"(bar) : "memory");
    asm volatile(
        "st.async.weak.shared::cluster.mbarrier::complete_tx::bytes"
        ".b32 [%0], %1, [%2];"
        :: "r"(in_block(smem_addr(&x.cand_z[par][rank]), lane)),
           "r"(__float_as_int(w.z)), "r"(bar) : "memory");
  }
  const unsigned bar = smem_addr(&x.bar[par]);
  const unsigned phase = ((k - 1) >> 1) & 1;   // this barrier's uses so far
  int spins = 0;
  while (!mbar_try_wait(bar, phase))
    if (++spins > (1 << 24)) __trap();   // a lost candidate: fail, not hang
  const int4 c = lane < CS ? x.cand[par][lane]
                           : make_int4(INT_MIN, INT_MAX, 0, 0);
  best = c.x;
  pick = c.y;
  warp_arg_max(best, pick);
  const int owner = (pick % TT) / T;           // the block that sent it
  const int4 w = x.cand[par][owner];
  lx = __int_as_float(w.z);
  ly = __int_as_float(w.w);
  lz = __int_as_float(x.cand_z[par][owner]);
  // arm this parity's barrier for its next use, two steps on
  if (tid == 0) mbar_expect(bar, CS * kCandidateBytes);
  return pick;
}

// (key, index) argmax over the block, the result in every thread; one
// __syncthreads, slots double-buffered by the step's parity.
template <int W>
__device__ __forceinline__ void block_arg_max(int2 (*s_warp)[W], int par,
                                              int warp, int lane, int& best,
                                              int& pick) {
  warp_arg_max(best, pick);
  if constexpr (W > 1) {
    if (lane == 0) s_warp[par][warp] = make_int2(best, pick);
    __syncthreads();
    const int2 c = lane < W ? s_warp[par][lane] : make_int2(INT_MIN, INT_MAX);
    best = c.x;
    pick = c.y;
    warp_arg_max(best, pick);
  }
}

template <int CS, int T, int P>
__global__ void __launch_bounds__(T, 1)
fps_kernel(const float* __restrict__ xyz, int n, int npoint,
           int* __restrict__ out) {
  constexpr int W = T / 32;        // warps of a block
  constexpr int TT = CS * T;       // threads of a scene
  static_assert(T % 32 == 0 && W <= 32 && CS <= 32, "one warp reduces the slots");
  static_assert(CS == 1 || W > 1, "the cluster's exchange leans on __syncthreads");
  extern __shared__ float4 s_xyz[];                 // [slot * T + thread]
  __shared__ int2 s_warp[2][W];                     // (key, index) per warp
  __shared__ Exchange<CS> s_x;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int rank = 0;
  int scene = blockIdx.x;
  if constexpr (CS > 1) {
    rank = static_cast<int>(cg::this_cluster().block_rank());
    scene = blockIdx.x / CS;
  }
  const int gt = rank * T + tid;
  const float* p = xyz + static_cast<size_t>(scene) * n * 3;
  int* o = out + static_cast<size_t>(scene) * npoint;

  float px[P], py[P], pz[P];
  int key[P];
#pragma unroll
  for (int s = 0; s < P; ++s) {
    const int j = s * TT + gt;
    float x = 0.0f, y = 0.0f, z = 0.0f;
    int k = kUnused;
    if (j < n) {
      x = __ldg(p + 3 * j);
      y = __ldg(p + 3 * j + 1);
      z = __ldg(p + 3 * j + 2);
      const float n2 = __fmaf_rn(z, z, __fmaf_rn(y, y, __fmul_rn(x, x)));
      k = n2 > 1e-3f ? __float_as_int(1e10f) : kPadding;
    }
    px[s] = x;
    py[s] = y;
    pz[s] = z;
    key[s] = k;
    s_xyz[s * T + tid] = make_float4(x, y, z, 0.0f);
  }
  float lx = __ldg(p), ly = __ldg(p + 1), lz = __ldg(p + 2);   // pick 0
  if (gt == 0) o[0] = 0;
  if constexpr (CS > 1) {
    if (tid == 0) exchange_init(s_x);
  }
  __syncthreads();
  // no block writes into another before all of the cluster's blocks run
  if constexpr (CS > 1) cg::this_cluster().sync();

  for (int k = 1; k < npoint; ++k) {
    const int par = k & 1;
    int best = INT_MIN;
    int slot = 0;
#pragma unroll
    for (int s = 0; s < P; ++s) {
      const float d2 = sq_dist(px[s], py[s], pz[s], lx, ly, lz);
      const int m = min(key[s], __float_as_int(d2));
      key[s] = m;
      if (m > best) {       // ascending index: strict '>' keeps the lowest
        best = m;
        slot = s;
      }
    }
    int pick = slot * TT + gt;
    block_arg_max<W>(s_warp, par, warp, lane, best, pick);
    // (best, pick) is this block's winner, one of its own points
    if constexpr (CS == 1) {
      const float4 w = s_xyz[pick];                 // TT == T: pick is the slot
      lx = w.x;
      ly = w.y;
      lz = w.z;
      if (tid == 0) o[k] = pick;
    } else {
      pick = cluster_pick<CS, TT, T>(
          s_x, k, rank, warp, lane, tid, best, pick,
          [&](int i) {
            const float4 w = s_xyz[(i / TT) * T + i % T];
            return make_float3(w.x, w.y, w.z);
          },
          lx, ly, lz);
      if (gt == 0) o[k] = pick;
    }
  }
  // no block leaves while another may still send to it or read from it
  if constexpr (CS > 1) cg::this_cluster().sync();
}

// The variant without a size limit (P == 0): a scene's points and running
// minimum stream from a workspace in device memory, 16 bytes a point
// (x, y, z and the key's bits), which each thread writes for its own points
// first and then reads once per step; the key goes back only where it
// fell.  Point j belongs to thread j % (CS*T), which scans j, j + CS*T, ...
// in ascending order; the argmax across warps and the cluster's exchange
// are the register variants'.  The pick's coordinates come from the input.
// At 100,000 points a cluster of 8 blocks streams 1.6 MB a step, which
// stays in L2.
template <int CS, int T>
__global__ void __launch_bounds__(T, 1)
fps_stream_kernel(const float* __restrict__ xyz, int n, int npoint,
                  int* __restrict__ out, float4* __restrict__ work) {
  constexpr int W = T / 32;
  constexpr int TT = CS * T;
  static_assert(T % 32 == 0 && W <= 32 && CS <= 32, "one warp reduces the slots");
  static_assert(CS > 1 && W > 1, "a cluster of several warps a block");
  __shared__ int2 s_warp[2][W];
  __shared__ Exchange<CS> s_x;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int scene = blockIdx.x / CS;
  const int gt = rank * T + tid;
  const float* p = xyz + static_cast<size_t>(scene) * n * 3;
  float4* wk = work + static_cast<size_t>(scene) * n;
  int* o = out + static_cast<size_t>(scene) * npoint;

  for (int j = gt; j < n; j += TT) {
    const float x = __ldg(p + 3 * j);
    const float y = __ldg(p + 3 * j + 1);
    const float z = __ldg(p + 3 * j + 2);
    const float n2 = __fmaf_rn(z, z, __fmaf_rn(y, y, __fmul_rn(x, x)));
    wk[j] = make_float4(
        x, y, z, __int_as_float(n2 > 1e-3f ? __float_as_int(1e10f) : kPadding));
  }
  float lx = __ldg(p), ly = __ldg(p + 1), lz = __ldg(p + 2);   // pick 0
  if (gt == 0) o[0] = 0;
  if (tid == 0) exchange_init(s_x);
  __syncthreads();
  cg::this_cluster().sync();

  for (int k = 1; k < npoint; ++k) {
    const int par = k & 1;
    int best = INT_MIN;
    int pick = gt;
    for (int j = gt; j < n; j += TT) {
      const float4 w = wk[j];
      const int key = __float_as_int(w.w);
      const int m = min(key, __float_as_int(sq_dist(w.x, w.y, w.z, lx, ly, lz)));
      if (m != key) wk[j].w = __int_as_float(m);
      if (m > best) {       // ascending index: strict '>' keeps the lowest
        best = m;
        pick = j;
      }
    }
    block_arg_max<W>(s_warp, par, warp, lane, best, pick);
    pick = cluster_pick<CS, TT, T>(
        s_x, k, rank, warp, lane, tid, best, pick,
        [&](int i) {
          // a block without points sends its key INT_MIN, which never wins,
          // with some point's coordinates
          const float* q = p + 3 * min(i, n - 1);
          return make_float3(__ldg(q), __ldg(q + 1), __ldg(q + 2));
        },
        lx, ly, lz);
    if (gt == 0) o[k] = pick;
  }
  cg::this_cluster().sync();
}

using Launcher = cudaError_t (*)(const float*, int, int, int, int*, float4*,
                                 cudaStream_t);

template <int CS, int T, int P>
cudaError_t launch(const float* xyz, int batch, int n, int npoint, int* out,
                   float4* work, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(batch) * CS);
  cfg.blockDim = dim3(T);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = CS > 1 ? 1 : 0;
  cudaError_t err;
  if constexpr (P == 0) {
    if (work == nullptr) return cudaErrorInvalidValue;
    err = cudaLaunchKernelEx(&cfg, fps_stream_kernel<CS, T>, xyz, n, npoint,
                             out, work);
  } else {
    auto kernel = fps_kernel<CS, T, P>;
    const size_t smem = static_cast<size_t>(T) * P * sizeof(float4);
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    cfg.dynamicSmemBytes = smem;
    err = cudaLaunchKernelEx(&cfg, kernel, xyz, n, npoint, out);
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

struct Variant {
  int cluster, threads, points;
  Launcher launch;
};

#define FPS_VARIANT(cs, t, p) {cs, t, p, &launch<cs, t, p>}
// The same list, in the same order, as VARIANTS of kernels/fps.py.
const Variant kVariants[] = {
    FPS_VARIANT(1, 32, 16),   FPS_VARIANT(1, 128, 4),   FPS_VARIANT(1, 128, 8),
    FPS_VARIANT(1, 256, 2),   FPS_VARIANT(1, 256, 4),   FPS_VARIANT(1, 256, 8),
    FPS_VARIANT(1, 512, 2),   FPS_VARIANT(1, 512, 4),   FPS_VARIANT(1, 1024, 2),
    FPS_VARIANT(8, 256, 4),   FPS_VARIANT(8, 256, 8),   FPS_VARIANT(8, 256, 12),
    FPS_VARIANT(8, 256, 16),  FPS_VARIANT(8, 256, 20),  FPS_VARIANT(8, 256, 24),
    FPS_VARIANT(8, 256, 32),  FPS_VARIANT(8, 256, 40),  FPS_VARIANT(8, 128, 40),
    FPS_VARIANT(8, 512, 10),  FPS_VARIANT(8, 1024, 5),  FPS_VARIANT(8, 1024, 0),
};
#undef FPS_VARIANT
constexpr int kNumVariants = sizeof(kVariants) / sizeof(kVariants[0]);

}  // namespace

extern "C" {

int fps_num_variants() { return kNumVariants; }

// (cluster size, threads per block, points per thread) of variant `v`.
int fps_variant_info(int v, int* cluster, int* threads, int* points) {
  if (v < 0 || v >= kNumVariants) return 1;
  *cluster = kVariants[v].cluster;
  *threads = kVariants[v].threads;
  *points = kVariants[v].points;
  return 0;
}

// xyz: (B, N, 3) float32, contiguous, on the device; out: (B, npoint) int32.
// `variant` indexes the list above and must hold N points (points 0: any
// N, with `work` a (B, N) float4 workspace on the device; null otherwise).
// Returns the launch's cudaError_t (0 on success); a refused launch is an
// error, no other kernel is tried.
int fps_launch(const float* xyz, int batch, int n, int npoint, int* out,
               int variant, void* work, void* stream) {
  if (variant < 0 || variant >= kNumVariants) return cudaErrorInvalidValue;
  const Variant& v = kVariants[variant];
  if (n < 1 || (v.points > 0 && n > v.cluster * v.threads * v.points))
    return cudaErrorInvalidValue;
  if (batch == 0 || npoint == 0) return 0;
  return static_cast<int>(v.launch(xyz, batch, n, npoint, out,
                                   static_cast<float4*>(work),
                                   static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
