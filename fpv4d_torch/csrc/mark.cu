// Section markers of the clip solve's device trace
// (fpv4d_torch/utils/observability.py `mark` and `section`).
//
// One empty kernel per section and edge, named
// fpv4d_mark_<section>_<edge> (extern "C", so the profiler's kernel
// records carry the name as it is). Launched on the current stream
// inside a step, a marker is captured into the step's CUDA graph like
// any kernel, so the device trace of every replay shows where each
// section's forward and backward begin and end. A marker runs one
// thread and touches no memory.
//
// The sections, in the order of observability.SECTIONS; each section's
// kernels in the order of observability.EDGES.
#include <cuda_runtime.h>

#define FPV4D_SECTIONS(X) \
  X(vposer) X(blend) X(fk) X(skin) X(contact) X(losses) X(adam) X(refresh)

#define FPV4D_KERNELS(s)                                        \
  extern "C" __global__ void fpv4d_mark_##s##_fwd_begin() {}    \
  extern "C" __global__ void fpv4d_mark_##s##_fwd_end() {}      \
  extern "C" __global__ void fpv4d_mark_##s##_bwd_begin() {}    \
  extern "C" __global__ void fpv4d_mark_##s##_bwd_end() {}
FPV4D_SECTIONS(FPV4D_KERNELS)

#define FPV4D_ENTRIES(s)                                        \
  reinterpret_cast<const void*>(&fpv4d_mark_##s##_fwd_begin),   \
  reinterpret_cast<const void*>(&fpv4d_mark_##s##_fwd_end),     \
  reinterpret_cast<const void*>(&fpv4d_mark_##s##_bwd_begin),   \
  reinterpret_cast<const void*>(&fpv4d_mark_##s##_bwd_end),
static const void* const kMarks[] = {FPV4D_SECTIONS(FPV4D_ENTRIES)};

// Launches marker `which` (section index x 4 + edge index) on `stream`
// and returns cudaGetLastError() (0 on success).
extern "C" int fpv4d_mark(int which, void* stream) {
  if (which < 0 || which >= static_cast<int>(sizeof(kMarks) /
                                             sizeof(kMarks[0])))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchKernel(kMarks[which], dim3(1), dim3(1), nullptr, 0,
                   static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
