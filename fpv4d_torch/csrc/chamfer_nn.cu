// K2: exact brute-force nearest neighbour of Q query points in an
// M-point cloud.
//
// Replaces the TPU kernel _nn_kernel of fpv4d/ops/chamfer_pallas.py
// (launched by _nn_forward there, public entry nn_distance; reached by
// the clip solve through nn.nn_brute). For each query x[q]:
//   d[m] = (dx*dx + dy*dy) + dz*dz  with (dx, dy, dz) = x[q] - y[m],
//   idx[q] = the first m of least d (ties to the smallest index),
//   dist[q] = d[idx[q]].
//
// What bounds it on an H100: at the global clip solve's shapes
// (Q = 900 frames x 813 contact vertices = 731,700 queries, M = 100,489
// scene points) it does 7.35e10 pairs x 8 f32 operations on the CUDA
// cores, 8.8 ms at 67 TFLOP/s, against ~16 MB of HBM traffic with each
// input read once and each output written once (5 us at 3.35 TB/s; the
// 1.2 MB cloud that every block re-reads stays in the 50 MB L2): it is
// bound by operations.
//
// Design: the TPU kernel's folded [-2x|1].[y||y|^2] matmul with bf16x3
// splits exists only because Mosaic ignores f32 matmul precision; here
// each pair's difference form is computed in f32 on the CUDA cores. One
// block of 256 threads takes 512 queries, two per thread, so every
// point read from shared memory serves two independent min chains. The
// cloud streams through shared memory in ascending tiles of 2,048
// points as float4 (32 KB); all threads of a warp read the same point
// (a broadcast), and the running (best, index) pairs stay in registers.
// The distance is written with __fsub_rn/__fmul_rn/__fadd_rn so nvcc
// cannot contract it into FMAs: it is then bit-identical to the plain
// PyTorch version, whose elementwise ops run unfused. Points are visited
// in ascending order and replace the best only on a strict `<`, so ties
// go to the smallest index, as torch.min does and as the TPU kernel's
// in-tile argmin and cross-tile `tile_min < prev` do.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 2;
constexpr int kQueries = kThreads * kPerThread;
constexpr int kTile = 2048;

__global__ void __launch_bounds__(kThreads)
chamfer_nn_kernel(const float* __restrict__ x, const float* __restrict__ y,
                  float* __restrict__ dist, int* __restrict__ idx, int Q,
                  int M) {
  __shared__ float4 sy[kTile];
  const int q0 = blockIdx.x * kQueries + threadIdx.x;
  float qx[kPerThread], qy[kPerThread], qz[kPerThread];
  float best[kPerThread];
  int bi[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int q = q0 + k * kThreads;
    const bool live = q < Q;
    qx[k] = live ? x[3 * q] : 0.f;
    qy[k] = live ? x[3 * q + 1] : 0.f;
    qz[k] = live ? x[3 * q + 2] : 0.f;
    best[k] = CUDART_INF_F;
    bi[k] = 0;
  }
  for (int base = 0; base < M; base += kTile) {
    const int m = min(kTile, M - base);
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < m; i += kThreads) {
      const int p = base + i;
      sy[i] = make_float4(y[3 * p], y[3 * p + 1], y[3 * p + 2], 0.f);
    }
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < m; ++i) {
      const float4 c = sy[i];
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        const float dx = __fsub_rn(qx[k], c.x);
        const float dy = __fsub_rn(qy[k], c.y);
        const float dz = __fsub_rn(qz[k], c.z);
        const float d = __fadd_rn(
            __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
            __fmul_rn(dz, dz));
        if (d < best[k]) {
          best[k] = d;
          bi[k] = base + i;
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int q = q0 + k * kThreads;
    if (q < Q) {
      dist[q] = best[k];
      idx[q] = bi[k];
    }
  }
}

}  // namespace

// Plain C entry for ctypes. All tensors contiguous: x [Q,3] f32,
// y [M,3] f32, dist [Q] f32, idx [Q] int32; Q >= 1, M >= 1 and 3*Q,
// 3*M < 2^31 (the wrapper checks). Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int chamfer_nn_forward(const void* x, const void* y, void* dist,
                                  void* idx, int Q, int M, void* stream) {
  const dim3 grid((Q + kQueries - 1) / kQueries);
  chamfer_nn_kernel<<<grid, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<float*>(dist), static_cast<int*>(idx), Q, M);
  return static_cast<int>(cudaGetLastError());
}
