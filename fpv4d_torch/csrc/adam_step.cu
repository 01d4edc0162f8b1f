// One step of optax's Adam over every leaf of one optimizer, in one
// launch (fpv4d_torch/ops/adam_cuda.py; solve/adam.py's kernel route).
//
// It replaces no TPU kernel: the JAX package leaves optax's update to
// XLA, which fuses it. The port's plain route is about 20 launches a
// step of torch's foreach kernels (zero_grad, 13 _foreach_* calls, the
// count and the two bias corrections), each of which gives a whole
// 512-thread block to every 65,536 elements of a leaf: at the clip
// solve's 85 k floats a handful of blocks walk their chunks while the
// other SMs idle. This kernel cuts the leaves into 512-element chunks,
// one 128-thread block each, from a table built once per optimizer
// (leaf pointers and sizes, then each chunk's leaf and first element),
// so a captured step replays with no host work.
//
// Bound: each element reads p, g, mu and nu and writes p, g, mu and nu
// (32 bytes): 2.7 MB at the clip solve's leaves, under a microsecond at
// 3.35 TB/s. A step this small is bound by its launch and one pass of
// memory latency, which is what one launch over all leaves is for.
//
// Arithmetic: each element follows the foreach route's operations in
// their order, each rounded on its own (the _rn intrinsics: nvcc may not
// contract a multiply and an add into an FMA), so the result has its
// bits on the card:
//   mu = mu*b1 + g*(1-b1);  nu = nu*b2 + (g*g)*(1-b2);
//   bc1 = 1 - b1^count;     bc2 = 1 - b2^count;
//   p = p + ((mu/bc1) / (sqrt(nu/bc2) + eps)) * (-lr)
// with the scalars cast to f32 as torch casts a Python float, and
// b^count by powf of the count as a float (torch.pow of a float and the
// int32 count). The gradient is written 0 after it is read: the step
// takes the place of zero_grad.
//
// The count: every block reads it and steps with count + 1; the last
// block to finish reading (an atomic ticket, reset by that block) writes
// count + 1, so no block of a step sees another's advance.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kPerThread = 4;

// solve/adam.py's leaf: its four tensors (each contiguous, f32) and
// their element count; ops/adam_cuda.py builds the table as int64 rows
struct Leaf {
  float* p;
  float* g;
  float* mu;
  float* nu;
  long long n;
};

struct Scalars {
  float b1, c1, b2, c2, eps, neg_lr;  // c1 = 1 - b1, c2 = 1 - b2
};

__global__ void __launch_bounds__(kThreads)
adam_step_kernel(const Leaf* __restrict__ leaves,
                 const int2* __restrict__ chunks, int* count,
                 unsigned int* ticket, Scalars s) {
  __shared__ float bc[2];
  if (threadIdx.x == 0) {
    const int step = *count + 1;
    const float t = __int2float_rn(step);
    bc[0] = __fsub_rn(1.0f, powf(s.b1, t));
    bc[1] = __fsub_rn(1.0f, powf(s.b2, t));
    __threadfence();  // this block's read of count before its ticket
    if (atomicAdd(ticket, 1u) == gridDim.x - 1) {
      __threadfence();
      *count = step;
      *ticket = 0u;
    }
  }
  __syncthreads();
  const float bc1 = bc[0], bc2 = bc[1];
  const int2 chunk = chunks[blockIdx.x];
  const Leaf leaf = leaves[chunk.x];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const long long i =
        static_cast<long long>(chunk.y) + k * kThreads + threadIdx.x;
    if (i >= leaf.n) break;
    const float g = leaf.g[i];
    const float mu = __fadd_rn(__fmul_rn(leaf.mu[i], s.b1),
                               __fmul_rn(g, s.c1));
    const float nu = __fadd_rn(__fmul_rn(leaf.nu[i], s.b2),
                               __fmul_rn(__fmul_rn(g, g), s.c2));
    const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(nu, bc2)), s.eps);
    const float upd = __fmul_rn(__fdiv_rn(__fdiv_rn(mu, bc1), den),
                                s.neg_lr);
    leaf.p[i] = __fadd_rn(leaf.p[i], upd);
    leaf.mu[i] = mu;
    leaf.nu[i] = nu;
    leaf.g[i] = 0.0f;
  }
}

}  // namespace

// One Adam step: `leaves` the device table of Leaf rows, `chunks`
// [n_chunks] (leaf, first element) pairs of kThreads * kPerThread
// elements, `count` the int32 step count, `ticket` an int32 that is 0
// between launches. Returns cudaGetLastError() (0 on success).
extern "C" int adam_step(const void* leaves, const void* chunks,
                         int n_chunks, void* count, void* ticket, float b1,
                         float c1, float b2, float c2, float eps,
                         float neg_lr, void* stream) {
  if (n_chunks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Scalars s{b1, c1, b2, c2, eps, neg_lr};
  adam_step_kernel<<<n_chunks, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Leaf*>(leaves), static_cast<const int2*>(chunks),
      static_cast<int*>(count), static_cast<unsigned int*>(ticket), s);
  return static_cast<int>(cudaGetLastError());
}
