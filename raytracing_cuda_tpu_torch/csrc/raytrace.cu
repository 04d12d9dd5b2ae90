// Raytracing megakernel for Hopper (sm_90a): the shipped launch and the
// counting launch. The kernel's body and its design notes are in
// raytrace_body.cuh; its diagnostic arms build from raytrace_arms.cu into a
// library of their own, so this one holds only what the render paths and
// chip_smoke.py's lane-efficiency line launch.
//
// Replaces the TPU megakernel raytracing_cuda_tpu/render/pallas_rt.py
// (_make_kernel, launched by raytrace_planes_batch at pallas_rt.py:1151).

#include "raytrace_body.cuh"

// coef: K x coef_rows x N_CHANNELS (rows n_rows.. are padding, never read);
// params: K x N_PARAMS; cull: n_groups x 3 int32 (first row, row count,
// nonzero where the group holds a row that blocks shadow rays), in the
// order of the bounds at P_CLUSTERS; tile_next: K int32 of scratch (the
// frames' tile counters, zeroed here on the stream before the kernel);
// out: 7 x K x H x W.
extern "C" int rt_raytrace_planes(const float* coef, int coef_rows, int n_rows,
                                  int tri_end, int sph_end,
                                  const float* params, const int* cull,
                                  int n_groups, float* out, int K, int H,
                                  int W, int row0, float inv_w1, float inv_h1,
                                  int* tile_next, void* stream) {
    return launch<false>(coef, coef_rows, n_rows, tri_end, sph_end, params,
                         cull, n_groups, out, K, H, W, row0, inv_w1, inv_h1,
                         tile_next, nullptr, stream);
}

// The counting launch: the same planes, and counts[0..3] += row tests the
// warps executed and their lanes needed for cast rays, then the same two
// for shadow rays (counts: 4 zeroed uint64 on the device).
extern "C" int rt_raytrace_count(const float* coef, int coef_rows, int n_rows,
                                 int tri_end, int sph_end,
                                 const float* params, const int* cull,
                                 int n_groups, float* out, int K, int H,
                                 int W, int row0, float inv_w1, float inv_h1,
                                 int* tile_next, unsigned long long* counts,
                                 void* stream) {
    return launch<true>(coef, coef_rows, n_rows, tri_end, sph_end, params,
                        cull, n_groups, out, K, H, W, row0, inv_w1, inv_h1,
                        tile_next, counts, stream);
}

extern "C" const char* rt_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
