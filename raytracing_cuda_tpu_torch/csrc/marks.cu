// Stage marks: four empty one-thread kernels with distinct names, launched
// at the stage boundaries of a frame graph captured for tracing
// (utils/profiling.py `mark`). Each does no work; in a profiler trace its
// start and end tell where one stage of the graph ends and the next
// begins, which a graph replay otherwise hides (its kernels keep only
// ATen's generic names). The order within a frame is begin, step, packs,
// then kernel A, then sky.
//
// extern "C" keeps the names unmangled, as the trace shows them.

#include <cuda_runtime.h>

extern "C" __global__ void stage_mark_begin() {}
extern "C" __global__ void stage_mark_step() {}
extern "C" __global__ void stage_mark_packs() {}
extern "C" __global__ void stage_mark_sky() {}

namespace {

const void* const MARKS[] = {
    reinterpret_cast<const void*>(stage_mark_begin),
    reinterpret_cast<const void*>(stage_mark_step),
    reinterpret_cast<const void*>(stage_mark_packs),
    reinterpret_cast<const void*>(stage_mark_sky),
};
constexpr int N_MARKS = sizeof(MARKS) / sizeof(MARKS[0]);

}  // namespace

// Loads every mark's module (lazy module loading defers it to the first
// launch otherwise, which must not fall inside a stream capture).
extern "C" int rt_marks_load() {
    cudaFuncAttributes attr;
    for (int i = 0; i < N_MARKS; ++i) {
        const cudaError_t err = cudaFuncGetAttributes(&attr, MARKS[i]);
        if (err != cudaSuccess) return (int)err;
    }
    return 0;
}

// One launch of mark `stage` (0 begin, 1 step, 2 packs, 3 sky) on `stream`.
extern "C" int rt_stage_mark(int stage, void* stream) {
    if (stage < 0 || stage >= N_MARKS) return (int)cudaErrorInvalidValue;
    const cudaError_t err = cudaLaunchKernel(MARKS[stage], dim3(1), dim3(1),
                                             nullptr, 0,
                                             (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

extern "C" const char* rt_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
