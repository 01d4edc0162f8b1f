// K1: per-frame contact nearest neighbour over candidate tables.
//
// Replaces the TPU kernel _cand_kernel of fpv4d/ops/cand_pallas.py
// (launched by _forward there, public entry cand_nn) and computes the
// f32 nn_to_candidates contract of fpv4d/ops/nn.py:
//   for frame t and query n:  d[p] = (dx*dx + dy*dy) + dz*dz, d = 1e4 on
//   invalid slots; slot = first argmin; dist = min(d[slot], 1e4);
//   nearest = cand[t, slot] where dist < 1e4, else q[t, n],
// bit-identical to cand_nn_plain (ops/cand_cuda.py).
//
// What bounds it on an H100: at the main path's shapes (T = 900 frames,
// N = 813 contact vertices, P = 192 candidates after compaction) it has
// 1.4e8 pairs, 4.2 us at one CUDA-core instruction per pair for the
// running minimum (the Gram product can go to the tensor cores), against
// 25.7 MB of HBM traffic with each input read once and each output
// written once (q and nearest dominate), 7.7 us at 3.35 TB/s: it is
// bound by bytes.
//
// Design: the tile routine of K2 (csrc/gram_nn.cuh: the Gram-form filter
// on the tensor cores, its margin and the exact re-check). One block of
// 4 warps takes a frame and 128 of its queries, 32 per warp, centred on
// the block's first query; warps whose rows are all past N only help to
// stage. The frame's candidates are read with coalesced loads (floats
// and valid bytes in order) in stages of 512, and split once per block
// into mma B fragments; an invalid slot carries |y|^2 = 1e30 and b = 0,
// so it never passes the margin once a row has a distance. A first
// pass over the first stage only lowers each row's minimum filter value,
// which bounds its best distance (upper_d) and sets its threshold; the
// second pass re-evaluates only the slots within the margin, so the
// running best never has to creep down slot by slot. A re-check
// follows the plain rule (an invalid slot counts 1e4). A row whose exact
// best is 1e4 or more, or that found none (no valid slot), rescans its
// P slots exactly with the 1e4 rule in ascending order with a strict
// `<`, which reproduces the plain version's winner at saturation.
//
// What holds it back (measured on an H100): at P = 192 a row has only
// six chunks, so its fixed costs outweigh its pairs: the seed pass
// doubles the mma and minima, and the bounds, the quad reduction and
// each of its ~2.5 re-checks (a chain of shared-memory round trips on
// one lane while its warp waits) come once per row. It runs slower than
// the CUDA-core design it replaced (PERF.md).
#include <cuda_runtime.h>

#include "gram_nn.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kQueries = kWarps * gram::kRowsPerWarp;
constexpr int kStage = 512;  // candidates per shared stage
constexpr float kBig = 1e4f;

__global__ void __launch_bounds__(kThreads, 8)
cand_nn_kernel(const float* __restrict__ q, const float* __restrict__ cand,
               const unsigned char* __restrict__ valid,
               float* __restrict__ dist, int* __restrict__ slot,
               float* __restrict__ nearest, int* __restrict__ rechecks,
               int N, int P) {
  // one block per (frame, 128 queries), the frames outermost on the
  // one grid axis that takes more than 65,535 blocks (folded fleets
  // reach 73 clips of 900 frames)
  const int nblk = (N + kQueries - 1) / kQueries;
  __shared__ uint4 frag[kStage / gram::kChunk * gram::kChunkFrags];
  __shared__ float raw[3 * kStage];
  __shared__ unsigned char rv[kStage];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int tf = blockIdx.x / nblk;
  const int n0 = (blockIdx.x % nblk) * kQueries;
  const long long qf = (long long)tf * N;  // first query row of the frame
  const float* cf = cand + (long long)tf * P * 3;
  const unsigned char* vf = valid + (long long)tf * P;
  const float cx = q[3 * (qf + n0)], cy = q[3 * (qf + n0) + 1],
              cz = q[3 * (qf + n0) + 2];

  __shared__ gram::RowState states[kWarps];
  gram::Rows s;
  bool live[gram::kRows];
  int n[gram::kRows];
  float qx[gram::kRows], qy[gram::kRows], qz[gram::kRows];
#pragma unroll
  for (int r = 0; r < gram::kRows; ++r) {
    n[r] = n0 + warp * gram::kRowsPerWarp + 16 * (r >> 1) + g + 8 * (r & 1);
    live[r] = n[r] < N;
    const long long i = 3 * (qf + n[r]);
    qx[r] = live[r] ? q[i] : 0.f;
    qy[r] = live[r] ? q[i + 1] : 0.f;
    qz[r] = live[r] ? q[i + 2] : 0.f;
  }
  gram::init_rows(s, &states[warp], lane, qx, qy, qz, live, cx, cy, cz);
  const bool warp_live = n0 + warp * gram::kRowsPerWarp < N;

  for (int base = 0; base < P; base += kStage) {
    const int m = min(kStage, P - base);
    __syncthreads();  // the previous stage is no longer read
    for (int i = threadIdx.x; i < 3 * m; i += kThreads)
      raw[i] = cf[3 * base + i];
    for (int i = threadIdx.x; i < m; i += kThreads) rv[i] = vf[base + i];
    __syncthreads();
    const int nchunks = (m + gram::kChunk - 1) / gram::kChunk;
    uint32_t* words = reinterpret_cast<uint32_t*>(frag);
    for (int p = threadIdx.x; p < nchunks * gram::kChunk; p += kThreads) {
      const bool real = p < m && rv[p];
      gram::stage(words, p, real ? raw[3 * p] : 0.f,
                  real ? raw[3 * p + 1] : 0.f, real ? raw[3 * p + 2] : 0.f,
                  real, cx, cy, cz);
    }
    __syncthreads();
    // re-checks read the stage from shared memory, with the plain rule
    const auto exact = [&](float qx, float qy, float qz, int p) {
      const int i = p - base;
      return rv[i] ? gram::exact_d(qx, qy, qz, raw[3 * i], raw[3 * i + 1],
                                   raw[3 * i + 2])
                   : kBig;
    };
    if (base == 0) {  // seed: the first stage's filter minimum
      float seed[gram::kRows] = {CUDART_INF_F, CUDART_INF_F, CUDART_INF_F,
                                 CUDART_INF_F};
      if (warp_live)
        for (int k = 0; k < nchunks; ++k)
          gram::seed_chunk(s, frag + k * gram::kChunkFrags, seed);
      gram::seed_bounds(s, seed);
    }
    if (warp_live) gram::tile(s, frag, nchunks, base, P, exact);
    if (base + kStage < P) gram::share_bounds(s);
  }

  gram::reduce_quad(s);
  if (t != 0) return;
#pragma unroll
  for (int r = 0; r < gram::kRows; ++r) {
    if (!live[r]) continue;
    float best = s.best(r);
    int bi = s.bi(r);
    if (!(best < kBig)) {  // saturated or no valid slot: rescan exactly
      const auto plain = [&](int p) {
        return vf[p] ? gram::exact_d(s.qx(r), s.qy(r), s.qz(r), cf[3 * p],
                                     cf[3 * p + 1], cf[3 * p + 2])
                     : kBig;
      };
      best = plain(0);
      bi = 0;
      for (int p = 1; p < P; ++p) {
        const float d = plain(p);
        if (d < best) {
          best = d;
          bi = p;
        }
      }
      s.rechecks(r) += P;
    }
    const long long i = qf + n[r];
    // min(best, 1e4), written so a NaN propagates as torch.clamp does
    const float dd = (best > kBig) ? kBig : best;
    const bool hit = dd < kBig;
    dist[i] = dd;
    slot[i] = bi;
    nearest[3 * i] = hit ? cf[3 * bi] : s.qx(r);
    nearest[3 * i + 1] = hit ? cf[3 * bi + 1] : s.qy(r);
    nearest[3 * i + 2] = hit ? cf[3 * bi + 2] : s.qz(r);
    if (rechecks != nullptr) rechecks[i] = s.rechecks(r);
  }
}

}  // namespace

// Plain C entry for ctypes. All tensors contiguous: q [T,N,3] f32,
// cand [T,P,3] f32, valid [T,P] bool (1 byte), dist [T,N] f32,
// slot [T,N] int32, nearest [T,N,3] f32; rechecks is null or [T,N]
// int32, which then receives each query's number of exact evaluations.
// T * ceil(N / 128) < 2^31 (the wrapper's int32 guard implies it).
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int cand_nn_forward(const void* q, const void* cand,
                               const void* valid, void* dist, void* slot,
                               void* nearest, void* rechecks, int T, int N,
                               int P, void* stream) {
  const unsigned nblk = (N + kQueries - 1) / kQueries;
  const dim3 grid(static_cast<unsigned>(T) * nblk);
  cand_nn_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(cand),
      static_cast<const unsigned char*>(valid), static_cast<float*>(dist),
      static_cast<int*>(slot), static_cast<float*>(nearest),
      static_cast<int*>(rechecks), N, P);
  return static_cast<int>(cudaGetLastError());
}
