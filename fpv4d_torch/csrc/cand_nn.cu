// K1: per-frame contact nearest neighbour over candidate tables.
//
// Replaces the TPU kernel _cand_kernel of fpv4d/ops/cand_pallas.py
// (launched by _forward there, public entry cand_nn) and computes the
// f32 nn_to_candidates contract of fpv4d/ops/nn.py:
//   for frame t and query n:  d[p] = (dx*dx + dy*dy) + dz*dz, d = 1e4 on
//   invalid slots; slot = first argmin; dist = min(d[slot], 1e4);
//   nearest = cand[t, slot] where dist < 1e4, else q[t, n].
//
// What bounds it on an H100: at the main path's shapes (T=900 frames,
// N~870 contact vertices, P=192 candidates after compaction) it does
// ~150 M candidate pairs x 8 f32 operations on the CUDA cores against
// ~25 MB of HBM traffic (q and nearest dominate), so it is bound by
// operations, not bytes (67 TFLOP/s f32 vs 3.35 TB/s).
//
// Design: one block per (frame, tile of 128 queries), one thread per
// query. The frame's candidates are staged in shared memory in chunks
// of 512 float4 (x, y, z, invalid flag; 8 KB), so any P works; every
// thread of a warp reads the same candidate, a shared-memory broadcast.
// The distance is written with __fmul_rn/__fadd_rn so nvcc cannot
// contract it into FMAs: the result is bit-identical to the plain
// PyTorch version, whose elementwise ops run unfused. A strict `<`
// keeps the smallest slot among ties, as torch.min does.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 512;
constexpr float kBig = 1e4f;

__global__ void __launch_bounds__(kThreads)
cand_nn_kernel(const float* __restrict__ q, const float* __restrict__ cand,
               const unsigned char* __restrict__ valid,
               float* __restrict__ dist, int* __restrict__ slot,
               float* __restrict__ nearest, int N, int P) {
  __shared__ float4 sc[kChunk];
  const int t = blockIdx.y;
  const int n = blockIdx.x * kThreads + threadIdx.x;
  const bool live = n < N;
  const long long qi = (long long)t * N + n;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (live) {
    qx = q[3 * qi];
    qy = q[3 * qi + 1];
    qz = q[3 * qi + 2];
  }
  const float* cf = cand + (long long)t * P * 3;
  const unsigned char* vf = valid + (long long)t * P;

  float best = 0.f;
  int bi = 0;
  for (int base = 0; base < P; base += kChunk) {
    const int m = min(kChunk, P - base);
    __syncthreads();  // the previous chunk is no longer read
    for (int i = threadIdx.x; i < m; i += kThreads) {
      const int p = base + i;
      sc[i] = make_float4(cf[3 * p], cf[3 * p + 1], cf[3 * p + 2],
                          vf[p] ? 0.f : 1.f);
    }
    __syncthreads();
    if (live) {
      for (int i = 0; i < m; ++i) {
        const float4 c = sc[i];
        const float dx = __fsub_rn(qx, c.x);
        const float dy = __fsub_rn(qy, c.y);
        const float dz = __fsub_rn(qz, c.z);
        float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                            __fmul_rn(dz, dz));
        if (c.w != 0.f) d = kBig;
        const int p = base + i;
        if (p == 0 || d < best) {
          best = d;
          bi = p;
        }
      }
    }
  }
  if (!live) return;
  // min(best, 1e4), written so a NaN propagates as torch.clamp does
  const float dd = (best > kBig) ? kBig : best;
  const bool hit = dd < kBig;
  dist[qi] = dd;
  slot[qi] = bi;
  nearest[3 * qi] = hit ? cf[3 * bi] : qx;
  nearest[3 * qi + 1] = hit ? cf[3 * bi + 1] : qy;
  nearest[3 * qi + 2] = hit ? cf[3 * bi + 2] : qz;
}

}  // namespace

// Plain C entry for ctypes. All tensors contiguous: q [T,N,3] f32,
// cand [T,P,3] f32, valid [T,P] bool (1 byte), dist [T,N] f32,
// slot [T,N] int32, nearest [T,N,3] f32. Launches on `stream` and
// returns cudaGetLastError() (0 on success).
extern "C" int cand_nn_forward(const void* q, const void* cand,
                               const void* valid, void* dist, void* slot,
                               void* nearest, int T, int N, int P,
                               void* stream) {
  const dim3 grid((N + kThreads - 1) / kThreads, T);
  cand_nn_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(cand),
      static_cast<const unsigned char*>(valid), static_cast<float*>(dist),
      static_cast<int*>(slot), static_cast<float*>(nearest), N, P);
  return static_cast<int>(cudaGetLastError());
}
