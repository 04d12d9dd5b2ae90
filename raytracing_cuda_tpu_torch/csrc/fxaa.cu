// FXAA post-pass for Hopper (sm_90a), one thread per pixel.
//
// Replaces the TPU kernel raytracing_cuda_tpu/render/fxaa.py
// (_make_fxaa_kernel, launched by fxaa_ext_pallas at fxaa.py:265), which
// holds a packed-int32 frame in VMEM and computes every tap of a 3x3
// stencil per (16, 256) tile. Here each thread reads its 3x3 neighbourhood
// of the uint8 (H, W, 3) frame straight from global memory (neighbouring
// threads share taps through L1) and writes its uint8 pixel.
//
// Bound: neither, by far. Per pixel it reads 3 bytes (9 taps, mostly cache
// hits) and writes 3, with ~140 float operations: at 1280x720, 5.5 MB of
// DRAM traffic (1.65 us at 3.35 TB/s) and ~0.13 GFLOP (~1.9 us at
// 67 TFLOP/s), so launch latency and the 3-byte pixel loads dominate.
//
// Semantics are the reference's antialiasing kernel (kernel.cu:262-403)
// as the JAX package states them: luminance min(255, rgb.w)/255 (rounded as
// the goldens were, see lum below), contrast skip at
// max(0.0312, 0.063 * high), the 12-tap blend
// through smoothstep, >= ties in the edge pick, clip and truncate, and
// image-border pixels passed through. Interior pixels only read in-bounds
// neighbours, so no edge padding is needed (and the reference's halo-load
// precedence bug at kernel.cu:318-319 has no counterpart).
//
// Frames: blockIdx.z is the frame of a (K, H, W, 3) batch, the counterpart
// of the JAX package's lax.map of the Pallas kernel over frames
// (render/pipeline.py:273-275); each frame is filtered on its own.
//
// Bands: a row-sharded frame (parallel/mesh.py) filters each h-row band
// with one halo row above and below, the neighbouring bands' quantized
// rows. The kernel takes a pointer to band row 0 and the per-frame input
// stride, so one body serves both forms; a pixel is interior by its global
// row row0 + y in a frame of total_h rows, as the TPU kernel judges it
// (params row0/total_h, fxaa.py:218-224). Halo contents at the frame's top
// and bottom are never read. A whole frame is the band h = total_h,
// row0 = 0 with no halo: no copy is added to the main path's launch.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_X = 32;
constexpr int BLOCK_Y = 8;

// Luminance rounded as XLA compiles the JAX package's stencil (the
// arithmetic that wrote the golden frames): explicit fmaf, then a multiply
// by f32(1/255). See render/fxaa.py `luminance` for why not a true divide.
__device__ __forceinline__ float lum(const uint8_t* __restrict__ img, int W,
                                     int y, int x) {
    const uint8_t* p = img + ((ptrdiff_t)y * W + x) * 3;   // y may be -1
    const float r = p[0], g = p[1], b = p[2];
    const float s = fmaf(b, 0.0721750f, fmaf(r, 0.2126729f, g * 0.7151522f));
    return fminf(255.0f, s) * (1.0f / 255.0f);
}

__global__ void __launch_bounds__(BLOCK_X * BLOCK_Y)
fxaa_kernel(const uint8_t* __restrict__ bands_in, size_t in_stride,
            uint8_t* __restrict__ frames_out, int h, int W, int row0,
            int total_h) {
    const int x = blockIdx.x * blockDim.x + threadIdx.x;
    const int y = blockIdx.y * blockDim.y + threadIdx.y;
    if (x >= W || y >= h) return;
    // `in` is band row 0 of this frame; an interior pixel reads rows y - 1
    // and y + 1, which lie in the halo rows at the band's edges
    const uint8_t* __restrict__ in = bands_in + (size_t)blockIdx.z * in_stride;
    uint8_t* __restrict__ out = frames_out + (size_t)blockIdx.z * h * W * 3;
    const size_t o = ((size_t)y * W + x) * 3;
    const int gy = row0 + y;                 // the pixel's row in its frame
    bool use_aa = x > 0 && gy > 0 && x < W - 1 && gy < total_h - 1;

    int nb_y = y, nb_x = x;
    float blend = 0.0f;
    if (use_aa) {
        const float lm = lum(in, W, y, x);
        const float ln = lum(in, W, y - 1, x);
        const float ls = lum(in, W, y + 1, x);
        const float le = lum(in, W, y, x + 1);
        const float lw = lum(in, W, y, x - 1);
        const float lne = lum(in, W, y - 1, x + 1);
        const float lnw = lum(in, W, y - 1, x - 1);
        const float lse = lum(in, W, y + 1, x + 1);
        const float lsw = lum(in, W, y + 1, x - 1);

        const float high = fmaxf(fmaxf(fmaxf(fmaxf(le, lw), ln), ls), lm);
        const float low = fminf(fminf(fminf(fminf(le, lw), ln), ls), lm);
        const float contrast = high - low;
        use_aa = !(contrast < fmaxf(0.0312f, 0.063f * high));

        float filt = (2.0f * (le + lw + ls + ln) + lne + lnw + lse + lsw) / 12.0f;
        filt = fminf(1.0f, fabsf(filt - lm) / contrast);
        blend = filt * filt * (3.0f - 2.0f * filt);

        const float hor = fabsf(ln + ls - 2.0f * lm) * 2.0f
                          + fabsf(lne + lse - 2.0f * le)
                          + fabsf(lnw + lsw - 2.0f * lw);
        const float ver = fabsf(le + lw - 2.0f * lm) * 2.0f
                          + fabsf(lne + lnw - 2.0f * ln)
                          + fabsf(lse + lsw - 2.0f * ls);
        if (hor >= ver) {
            nb_y = fabsf(ln - lm) >= fabsf(ls - lm) ? y - 1 : y + 1;
        } else {
            nb_x = fabsf(le - lm) >= fabsf(lw - lm) ? x + 1 : x - 1;
        }
    }
    const ptrdiff_t nb = ((ptrdiff_t)nb_y * W + nb_x) * 3;
    for (int c = 0; c < 3; ++c) {
        const float cm = in[o + c];
        if (use_aa) {
            const float v = (float)in[nb + c] * blend
                            + cm * (1.0f - blend);
            out[o + c] = (uint8_t)fminf(fmaxf(v, 0.0f), 255.0f);
        } else {
            out[o + c] = in[o + c];
        }
    }
}

}  // namespace

// bands_in: K frames' band row 0, frame k at bands_in + k * in_stride bytes;
// band rows -1 and h (the halo rows) are read only for interior pixels.
// out: K x h x W x 3 uint8. A whole frame is h = total_h, row0 = 0,
// in_stride = h * W * 3: its border rows pass through and no halo is read.
extern "C" int rt_fxaa(const uint8_t* bands_in, size_t in_stride,
                       uint8_t* out, int K, int h, int W, int row0,
                       int total_h, void* stream) {
    if (K < 1 || K > 65535 || h < 1 || W < 1 || row0 < 0
        || row0 + h > total_h)
        return (int)cudaErrorInvalidValue;
    const dim3 block(BLOCK_X, BLOCK_Y);
    const dim3 grid((W + BLOCK_X - 1) / BLOCK_X, (h + BLOCK_Y - 1) / BLOCK_Y,
                    K);
    fxaa_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        bands_in, in_stride, out, h, W, row0, total_h);
    return (int)cudaGetLastError();
}

extern "C" const char* rt_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
