// K2: exact brute-force nearest neighbour of Q query points in an
// M-point cloud.
//
// Replaces the TPU kernel _nn_kernel of fpv4d/ops/chamfer_pallas.py
// (launched by _nn_forward there, public entry nn_distance; reached by
// the clip solve through nn.nn_brute). For each query x[q]:
//   d[m] = (dx*dx + dy*dy) + dz*dz  with (dx, dy, dz) = x[q] - y[m],
//   idx[q] = the first m of least d (ties to the smallest index),
//   dist[q] = d[idx[q]],
// bit-identical to nn_distance_plain (ops/chamfer_cuda.py). A leading
// clip axis (the multi-clip fleet's padded scenes, the reference's
// pallas_call under vmap) is the grid's y axis: clip c searches its own
// Q queries in its own M-point cloud, in the same launch.
//
// What bounds it on an H100: at the global clip solve's shapes
// (Q = 900 frames x 813 contact vertices = 731,700 queries, M = 100,489
// scene points) it has 7.35e10 pairs against ~16 MB of HBM traffic with
// each input read once and each output written once (5 us at 3.35 TB/s;
// the 1.2 MB cloud that every block re-reads stays in the 50 MB L2).
// The Gram product can go to the tensor cores; what must stay on the
// CUDA cores is at least one instruction per pair for the running
// minimum: 7.35e10 / (132 SMs x 128 lanes x 1.98 GHz) = 2.2 ms. It is
// bound by operations.
//
// Design: the TPU kernel's folded Gram form, on the tensor cores, as a
// filter with an exact re-check (csrc/gram_nn.cuh holds the tile
// routine, the margin's proof and the fragment layouts). A block of 8
// warps takes 256 queries, 32 per warp (two m16 tiles), centred on the
// block's first query; what a warp keeps of its rows outside the hot
// loop lies in shared memory, so 80 registers a thread let 3 blocks
// share an SM. The cloud streams through shared memory in tiles of
// 1,024 points: cp.async brings the next tile's f32 coordinates in while
// the current one is searched, and the block splits each tile once
// (centre, |b|^2, bf16 hi/lo) into mma B fragments. Per 32 points a warp
// issues eight m16n8k16 mma whose accumulators start at minus each
// row's threshold, and tests the results' sign bits; the points whose
// value comes out negative are re-evaluated exactly, so dist and idx
// are those of the plain version. Re-checks are done where they arise, so there is
// no buffer to overflow and no row ever needs a rescan.
//
// Seeding. A pass over 1,024 points spread over the cloud finds the
// tile where the block's first query has its nearest seed; a pass over
// that tile gives every row an upper bound on its best distance
// (upper_d), and so a threshold, before any re-check; and the scan
// starts at that tile. Without them, a cloud stored in spatial order (a
// scanned floor, row by row) lowers each row's best step by step and
// re-checks at every step. After each tile the quad's rows share their
// best exact distances.
//
// What holds it back (probed on an H100 with variants of this file):
// the tensor cores run well below their mma.sync rate, and neither two
// chunks per turn, more blocks per SM nor a bank-conflict-free staging
// order moved it; PERF.md has the kernel's times.
#include <cuda_runtime.h>

#include <atomic>

#include "gram_nn.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kQueries = kWarps * gram::kRowsPerWarp;
constexpr int kTile = 1024;  // points per shared tile
constexpr int kSeedChunks = kTile / gram::kChunk;  // seed: one tile
constexpr int kFrags = kSeedChunks * gram::kChunkFrags;
constexpr int kSmem = kFrags * 16 + 2 * 3 * kTile * 4;  // 56 KB
constexpr int kMaxDevices = 64;  // devices whose attribute is tracked

__device__ __forceinline__ void copy_word(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

// issue the cp.async copies of tile `base` (n points) into raw
__device__ __forceinline__ void fetch_tile(float* raw, const float* y,
                                           int base, int n) {
  for (int i = threadIdx.x; i < 3 * n; i += kThreads)
    copy_word(raw + i, y + 3 * base + i);
  asm volatile("cp.async.commit_group;\n" ::);
}

__global__ void __launch_bounds__(kThreads, 3)
chamfer_nn_kernel(const float* __restrict__ x, const float* __restrict__ y,
                  float* __restrict__ dist, int* __restrict__ idx,
                  int* __restrict__ rechecks, int Q, int M) {
  {  // clip blockIdx.y: its queries, cloud and outputs
    const long long clip = blockIdx.y;
    x += 3 * clip * Q;
    y += 3 * clip * M;
    dist += clip * Q;
    idx += clip * Q;
    if (rechecks != nullptr) rechecks += clip * Q;
  }
  // dynamic: kTile / 32 staged chunks, then two f32 tiles
  extern __shared__ uint4 frag[];
  float* const raw = reinterpret_cast<float*>(frag + kFrags);
  __shared__ int start_tile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kQueries;
  const float cx = x[3 * q0], cy = x[3 * q0 + 1], cz = x[3 * q0 + 2];

  __shared__ gram::RowState states[kWarps];
  gram::Rows s;
  bool live[gram::kRows];
  int qi[gram::kRows];
  float qx[gram::kRows], qy[gram::kRows], qz[gram::kRows];
#pragma unroll
  for (int r = 0; r < gram::kRows; ++r) {
    qi[r] = q0 + warp * gram::kRowsPerWarp + 16 * (r >> 1) + g + 8 * (r & 1);
    live[r] = qi[r] < Q;
    qx[r] = live[r] ? x[3 * qi[r]] : 0.f;
    qy[r] = live[r] ? x[3 * qi[r] + 1] : 0.f;
    qz[r] = live[r] ? x[3 * qi[r] + 2] : 0.f;
  }
  gram::init_rows(s, &states[warp], lane, qx, qy, qz, live, cx, cy, cz);
  const bool warp_live = q0 + warp * gram::kRowsPerWarp < Q;
  uint32_t* words = reinterpret_cast<uint32_t*>(frag);
  const int ntiles = (M + kTile - 1) / kTile;

  // Seed: kSeedChunks chunks spread evenly over the cloud give the
  // block's first query the tile where its nearest seed lies; the scan
  // starts there, so near points come first. That tile's points seed
  // too, and the least filter value of both gives each row an upper
  // bound on its best distance, and a threshold, before any re-check.
  const int C = (M + gram::kChunk - 1) / gram::kChunk;
  const int nseed = min(kSeedChunks, C);
  for (int p = threadIdx.x; p < nseed * gram::kChunk; p += kThreads) {
    const int m = (p / gram::kChunk) * C / nseed * gram::kChunk +
                  p % gram::kChunk;
    const bool real = m < M;
    gram::stage(words, p, real ? y[3 * m] : 0.f, real ? y[3 * m + 1] : 0.f,
          real ? y[3 * m + 2] : 0.f, real, cx, cy, cz);
  }
  __syncthreads();
  float seed_min = CUDART_INF_F;
  int seed_at = 0;
  float seed[gram::kRows] = {CUDART_INF_F, CUDART_INF_F, CUDART_INF_F,
                             CUDART_INF_F};
  if (warp_live) {
    for (int k = 0; k < nseed; ++k) {
      const float v = gram::seed_chunk(s, frag + k * gram::kChunkFrags,
                                       seed);
      if (v < seed_min) {
        seed_min = v;
        seed_at = k;
      }
    }
  }
  if (warp == 0) {  // row 0 of warp 0 is the block's first query
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, seed_min, off);
      const int oa = __shfl_xor_sync(0xffffffffu, seed_at, off);
      if (ov < seed_min || (ov == seed_min && oa < seed_at)) {
        seed_min = ov;
        seed_at = oa;
      }
    }
    if (lane == 0)
      start_tile = (seed_at * C / nseed) * gram::kChunk / kTile;
  }
  __syncthreads();  // start_tile is set; frag is no longer read
  const int j0 = start_tile;
  const int n0 = min(kTile, M - j0 * kTile);
  // ... and the whole start tile seeds too, before the bound is taken
  fetch_tile(raw, y, j0 * kTile, n0);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  const int nseed0 = (n0 + gram::kChunk - 1) / gram::kChunk;
  for (int p = threadIdx.x; p < nseed0 * gram::kChunk; p += kThreads) {
    const bool real = p < n0;
    gram::stage(words, p, real ? raw[3 * p] : 0.f, real ? raw[3 * p + 1] : 0.f,
          real ? raw[3 * p + 2] : 0.f, real, cx, cy, cz);
  }
  __syncthreads();
  if (warp_live)
    for (int k = 0; k < nseed0; ++k)
      gram::seed_chunk(s, frag + k * gram::kChunkFrags, seed);
  gram::seed_bounds(s, seed);
  __syncthreads();  // frag and raw are no longer read

  fetch_tile(raw, y, j0 * kTile, min(kTile, M - j0 * kTile));
  for (int j = 0; j < ntiles; ++j) {
    const int jt = (j0 + j) % ntiles;
    const int base = jt * kTile;
    const int n = min(kTile, M - base);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();  // tile jt is in raw; the previous tile is done with
    if (j + 1 < ntiles) {  // the next tile streams in behind this one
      const int jn = (jt + 1) % ntiles;
      fetch_tile(raw + ((j + 1) & 1) * 3 * kTile, y, jn * kTile,
                 min(kTile, M - jn * kTile));
    }
    const float* rj = raw + (j & 1) * 3 * kTile;
    // re-checks read the tile's f32 coordinates from shared memory
    const auto exact = [&](float qx, float qy, float qz, int m) {
      const float* p = rj + 3 * (m - base);
      return gram::exact_d(qx, qy, qz, p[0], p[1], p[2]);
    };
    const int nchunks = (n + gram::kChunk - 1) / gram::kChunk;
    for (int p = threadIdx.x; p < nchunks * gram::kChunk; p += kThreads) {
      const bool real = p < n;
      gram::stage(words, p, real ? rj[3 * p] : 0.f, real ? rj[3 * p + 1] : 0.f,
            real ? rj[3 * p + 2] : 0.f, real, cx, cy, cz);
    }
    __syncthreads();
    if (warp_live) gram::tile(s, frag, nchunks, base, M, exact);
    gram::share_bounds(s);
  }

  gram::reduce_quad(s);
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < gram::kRows; ++r) {
      if (!live[r]) continue;
      dist[qi[r]] = s.best(r);
      idx[qi[r]] = s.bi(r);
      if (rechecks != nullptr) rechecks[qi[r]] = s.rechecks(r);
    }
  }
}

}  // namespace

// Plain C entry for ctypes. All tensors contiguous: x [C,Q,3] f32,
// y [C,M,3] f32, dist [C,Q] f32, idx [C,Q] int32 (each clip's indices
// into its own cloud); rechecks is null or [C,Q] int32, which then
// receives each query's number of exact re-evaluations. Q >= 1, M >= 1,
// 1 <= C <= 65,535 and 3*Q, 3*M < 2^31 (the wrapper checks). Launches on
// `stream` and returns cudaGetLastError() (0 on success). The kernel's
// shared-memory attribute is set on the first launch on each device only,
// so a launch inside a CUDA graph capture makes no other runtime call.
extern "C" int chamfer_nn_forward(const void* x, const void* y, void* dist,
                                  void* idx, void* rechecks, int Q, int M,
                                  int C, void* stream) {
  static std::atomic<bool> prepared[kMaxDevices];
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (device < 0 || device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (!prepared[device].load()) {
    e = cudaFuncSetAttribute(chamfer_nn_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    prepared[device].store(true);
  }
  const dim3 grid((Q + kQueries - 1) / kQueries, C);
  chamfer_nn_kernel<<<grid, kThreads, kSmem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<float*>(dist), static_cast<int*>(idx),
      static_cast<int*>(rechecks), Q, M);
  return static_cast<int>(cudaGetLastError());
}
