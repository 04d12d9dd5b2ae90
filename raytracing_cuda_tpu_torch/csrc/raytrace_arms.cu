// The raytracing megakernel's diagnostic arms (sm_90a): static variants of
// the body in raytrace_body.cuh for cost decomposition, the counterparts of
// the TPU kernel's `ablate` arms (raytracing_cuda_tpu/render/pallas_rt.py
// _make_kernel, :559-584) and of its t_bound=False knob. Launched by
// render/cuda_rt.py raytrace_planes(_batch)(ablate=...) and by
// experiments/megakernel_ablation_torch.py; no render path launches them.
//
// Each arm removes work from the shipped body (ARM_* in the header), so it
// is bound by operations as the body is, and its time beside the shipped
// kernel's splits the frame's cost: the shadow sweeps (ARM_NOSHADOW), the
// levels past N (DEPTH = N), the shading (ARM_NOSHADE), the per-ray culls
// (ARM_NOCULL), their t-bound (ARM_NO_TBOUND) and the plane-first shadow
// test (ARM_NOHCULL, the counterpart of the TPU's below-horizon cull).
// Arms that run the same instructions share one instantiation: render/
// cuda_rt.py parse_ablate normalises a set of arms to one (arms, depth)
// pair, and ARMS_ON_CARD there lists the pairs below.

#include "raytrace_body.cuh"

// The arguments of rt_raytrace_planes (raytrace.cu), then the normalised
// arm bits and the last level; cudaErrorInvalidValue for a pair that is
// not instantiated here.
extern "C" int rt_raytrace_arms(const float* coef, int coef_rows, int n_rows,
                                int tri_end, int sph_end, const float* params,
                                const int* cull, int n_groups, float* out,
                                int K, int H, int W, int row0, float inv_w1,
                                float inv_h1, int arms, int depth,
                                int* tile_next, void* stream) {
#define RT_ARM(A, D)                                                       \
    if (arms == (A) && depth == (D))                                       \
        return launch<false, (A), (D)>(coef, coef_rows, n_rows, tri_end,   \
                                       sph_end, params, cull, n_groups,    \
                                       out, K, H, W, row0, inv_w1, inv_h1, \
                                       tile_next, nullptr, stream);
    RT_ARM(0, 0)
    RT_ARM(0, 1)
    RT_ARM(0, 2)
    RT_ARM(0, 3)
    RT_ARM(0, MAX_DEPTH)
    RT_ARM(ARM_NOSHADOW, MAX_DEPTH)
    RT_ARM(ARM_NOSHADE, MAX_DEPTH)
    RT_ARM(ARM_NOCULL | ARM_NOHCULL, MAX_DEPTH)
    RT_ARM(ARM_NO_TBOUND, MAX_DEPTH)
    RT_ARM(ARM_NOHCULL, MAX_DEPTH)
#undef RT_ARM
    return (int)cudaErrorInvalidValue;
}

extern "C" const char* rt_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
