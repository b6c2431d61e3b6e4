// Native host data plane for the input pipeline (the same source as
// scan2cap_tpu/native/dataplane.cc).
//
// The device runs the model; the host side replaces the reference's
// torch DataLoader workers (lib/dataset.py __getitem__, num_workers=4,
// scripts/train.py:52) with a small C++ library driven through ctypes.  It
// implements the per-sample hot loops:
//
//   * sample_gather      — random-subset row gather (utils/pc_utils.py:32-40's
//                          gather half; the index draw stays in numpy so runs
//                          remain reproducible against the Python path)
//   * augment_points     — YZ/XZ flips + rotation + translation applied to the
//                          xyz columns in place (lib/dataset.py:395-425)
//   * point_votes        — per-point offset to its instance's bbox center,
//                          computed in two O(M) passes instead of the
//                          reference's O(instances x M) masked loop
//                          (lib/dataset.py:427-442)
//
// Plain C ABI: every array is a caller-allocated contiguous buffer.  Threads
// come from a tiny fork/join pool over row ranges.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// run fn(begin, end) over [0, n) split across up to `threads` workers
template <typename F>
void parallel_rows(int64_t n, int threads, F fn) {
  if (threads <= 1 || n < (1 << 14)) {
    fn(0, n);
    return;
  }
  int nt = threads;
  std::vector<std::thread> pool;
  pool.reserve(nt - 1);
  int64_t chunk = (n + nt - 1) / nt;
  for (int t = 1; t < nt; ++t) {
    int64_t b = t * chunk, e = std::min(n, (t + 1) * chunk);
    if (b >= e) break;
    pool.emplace_back([=] { fn(b, e); });
  }
  fn(0, std::min(n, chunk));
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// dst[i, :] = src[idx[i], :]
void s2c_sample_gather(const float* src, const int32_t* idx, float* dst,
                       int64_t n_out, int64_t n_cols, int threads) {
  // partition whole rows per thread (element-space splits would hand the
  // boundary row to two threads — a data race even if the bytes agree)
  parallel_rows(n_out, threads, [&](int64_t b, int64_t e) {
    for (int64_t i = b; i < e; ++i) {
      std::memcpy(dst + i * n_cols, src + int64_t(idx[i]) * n_cols,
                  sizeof(float) * n_cols);
    }
  });
}

// xyz columns (0..2) of pc (m x c): optional flips, then rot (3x3 row-major,
// applied as x' = x @ R^T like np.dot(pc, rot.T)), then translation.
void s2c_augment_points(float* pc, int64_t m, int64_t c, int flip_yz,
                        int flip_xz, const float* rot, const float* trans,
                        int threads) {
  parallel_rows(m, threads, [&](int64_t b, int64_t e) {
    for (int64_t i = b; i < e; ++i) {
      float* p = pc + i * c;
      float x = flip_yz ? -p[0] : p[0];
      float y = flip_xz ? -p[1] : p[1];
      float z = p[2];
      // match np.dot(pc[:, :3], rot.T) exactly: row i of result is
      // sum_k pc[k] * rot[j, k], accumulated left to right
      float nx = x * rot[0] + y * rot[1] + z * rot[2];
      float ny = x * rot[3] + y * rot[4] + z * rot[5];
      float nz = x * rot[6] + y * rot[7] + z * rot[8];
      p[0] = nx + trans[0];
      p[1] = ny + trans[1];
      p[2] = nz + trans[2];
    }
  });
}

// Per-point vote to the instance's axis-aligned center ((min+max)/2 over ALL
// of the instance's points).  Votes are written only for instances whose
// FIRST point (in index order) has care[i] != 0 — the reference gates on
// semantic_labels[ind[0]] (lib/dataset.py:427-442), not per point.
// Instance ids are int32; id_cap bounds the dense scratch table (ScanNet uses
// small consecutive ids).  votes: (m x 3) out, mask: (m,) out.  Returns 0 on
// success, -1 if an instance id is out of [0, id_cap).
int s2c_point_votes(const float* xyz, int64_t xyz_stride,
                    const int32_t* instance, const uint8_t* care, int64_t m,
                    int32_t id_cap, float* votes, float* mask) {
  std::vector<float> mins(size_t(id_cap) * 3, 1e30f);
  std::vector<float> maxs(size_t(id_cap) * 3, -1e30f);
  std::vector<uint8_t> seen(id_cap, 0);
  std::vector<uint8_t> cared(id_cap, 0);
  for (int64_t i = 0; i < m; ++i) {
    int32_t id = instance[i];
    if (id < 0) continue;
    if (id >= id_cap) return -1;
    const float* p = xyz + i * xyz_stride;
    float* mn = mins.data() + size_t(id) * 3;
    float* mx = maxs.data() + size_t(id) * 3;
    for (int k = 0; k < 3; ++k) {
      if (p[k] < mn[k]) mn[k] = p[k];
      if (p[k] > mx[k]) mx[k] = p[k];
    }
    if (!seen[id]) {
      seen[id] = 1;
      cared[id] = care[i];  // first point in index order decides
    }
  }
  for (int64_t i = 0; i < m; ++i) {
    int32_t id = instance[i];
    float* v = votes + i * 3;
    if (id < 0 || !seen[id] || !cared[id]) {
      v[0] = v[1] = v[2] = 0.0f;
      mask[i] = 0.0f;
      continue;
    }
    const float* p = xyz + i * xyz_stride;
    const float* mn = mins.data() + size_t(id) * 3;
    const float* mx = maxs.data() + size_t(id) * 3;
    for (int k = 0; k < 3; ++k) {
      // 0.5 * (min + max) in f32, then subtract — matches the numpy order
      v[k] = 0.5f * (mn[k] + mx[k]) - p[k];
    }
    mask[i] = 1.0f;
  }
  return 0;
}

}  // extern "C"
