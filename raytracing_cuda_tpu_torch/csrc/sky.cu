// The sky lookup and quantize for Hopper (sm_90a): one launch turns kernel
// A's seven planes of K frames into their uint8 base frames (render/sky.py
// `sky_quantize`, called by render/pipeline.py `_base` and
// `bases_from_packs`).
//
// Replaces no TPU kernel: the JAX package resolves its sky with XLA ops
// after the Pallas megakernel (raytracing_cuda_tpu/render/pipeline.py:83-152,
// `_pallas_base`).
// The port's torch version of the same stage (render/sky.py
// `sky_quantize_torch`: scene/textures.py `sample_sky_packed_pair`, then
// `quantize`) is some thirty kernels a frame, each writing a full-frame
// float32 temporary.
//
// Bound: bytes. A pixel reads its seven float32 planes (28 bytes), a sky
// pixel two packed texels (8 more), and writes 3 bytes: at 1280x720 at most
// 36 MB, 10.7 us at 3.35 TB/s, beside some 60 float operations a sky
// pixel. The design:
//   - the planes are read where kernel A wrote them, nothing stacked;
//   - each thread owns 4 neighbouring pixels of one frame: 16-byte loads of
//     each plane and its 12 output bytes as three aligned 32-bit stores,
//     where a frame's pixel count is a multiple of 4 and the planes are
//     16-byte aligned (the wrapper's frames; byte stores otherwise, and for
//     a ragged tail);
//   - where the miss weight is 0 (a ray that ends on geometry) the
//     direction planes are not read and no texel is fetched: r + 0 * sky is
//     r, and quantize clamps a signed zero to the same byte;
//   - gridDim.z is the frame; each frame's clock (day_time, K) and sky
//     weights (sky_vars, K x 4) are read on the device, so a CUDA graph
//     captures the launch and nothing is read back.
//
// Bit identity with the torch version on the same card: every operation is
// the torch code's, in its order, each rounded on its own (built with
// -fmad=false, as torch's separate elementwise kernels are): the clamp
// that keeps NaN, asinf and atan2f, true divisions, remainder as fmodf with
// the sign fix, the float-to-int casts (to uint8 through int64, as c10
// casts), first-index argmax with NaN as the largest. The float constants
// are the Python module's, passed in.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int PX = 4;                // pixels a thread
constexpr int N_PLANES = 7;          // r, g, b, mw, mdx, mdy, mdz
constexpr int MW = 3;                // the miss weight's plane

struct Args {
    const float* plane[N_PLANES];    // K x n each
    const int* sky;                  // 4 x (sky_h * sky_w): r | g<<8 | b<<16
    const float* day_time;           // K
    const float* sky_vars;           // K x 4
    uint8_t* out;                    // K x n x 3
    long long n;                     // pixels a frame
    int sky_h, sky_w;
    float half_pi, pi, two_pi, inv_255;
    bool vec;                        // 16-byte loads, 32-bit stores
};

// torch.clamp: NaN passes through
__device__ __forceinline__ float clamp_keep_nan(float v, float lo, float hi) {
    return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// torch.argmax over 4: the first index of the largest, NaN the largest;
// the index and its value (no array is indexed at run time, so none
// leaves registers)
struct Max {
    int i;
    float v;
};

__device__ __forceinline__ Max argmax4(const float (&w)[4]) {
    Max m{0, w[0]};
    #pragma unroll
    for (int i = 1; i < 4; ++i)
        if (!isnan(m.v) && (isnan(w[i]) || w[i] > m.v)) m = {i, w[i]};
    return m;
}

// scene/textures.py sky_blend_bands: the two active panoramas and weights
struct Bands {
    long long off_a, off_b;          // ia, ib times the panorama's texels
    float wa, wb;
};

__device__ __forceinline__ Bands blend_bands(const Args& a, int k) {
    float w[4], masked[4];
    #pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = a.sky_vars[4 * k + i];
    const Max ma = argmax4(w);
    #pragma unroll
    for (int i = 0; i < 4; ++i) masked[i] = i == ma.i ? -1.0f : w[i];
    const Max mb = argmax4(masked);
    const long long n_sky = (long long)a.sky_h * a.sky_w;
    return {ma.i * n_sky, mb.i * n_sky, ma.v,
            isnan(mb.v) ? mb.v : fmaxf(mb.v, 0.0f)};
}

// torch.remainder(x, 1.0) on float32
__device__ __forceinline__ float remainder1(float x) {
    const float m = fmodf(x, 1.0f);
    return m < 0.0f ? m + 1.0f : m;
}

// one pixel: rgb + mw * sky (the pair lookup of sample_sky_packed_pair),
// quantized to 3 bytes
__device__ __forceinline__ void shade(const Args& a, const Bands& bd,
                                      float day_frac, const float* v,
                                      uint8_t* o) {
    float c[3] = {v[0], v[1], v[2]};
    const float mw = v[MW];
    if (mw != 0.0f) {
        // _equirect_indices
        const float y = 1.0f - (asinf(clamp_keep_nan(v[5], -1.0f, 1.0f))
                                + a.half_pi) / a.pi;
        const float x = remainder1((atan2f(v[4], v[6]) + a.pi) / a.two_pi
                                   + day_frac);
        const int ix = min(max((int)(x * (float)a.sky_w), 0), a.sky_w - 1);
        const int iy = min(max((int)(y * (float)a.sky_h), 0), a.sky_h - 1);
        const long long idx = iy * a.sky_w + ix;
        const int ta = a.sky[bd.off_a + idx];
        const int tb = a.sky[bd.off_b + idx];
        #pragma unroll
        for (int s = 0; s < 3; ++s) {
            const float sky = (floorf((float)((ta >> (8 * s)) & 0xFF) * bd.wa)
                               + floorf((float)((tb >> (8 * s)) & 0xFF)
                                        * bd.wb)) * a.inv_255;
            c[s] = c[s] + mw * sky;
        }
    }
    #pragma unroll
    for (int s = 0; s < 3; ++s)       // quantize
        o[s] = (uint8_t)(long long)clamp_keep_nan(c[s] * 255.0f, 0.0f,
                                                  255.0f);
}

__global__ void __launch_bounds__(THREADS) sky_quantize_kernel(const Args a) {
    const int k = blockIdx.z;
    const long long p0 = ((long long)blockIdx.x * THREADS + threadIdx.x) * PX;
    if (p0 >= a.n) return;
    const long long at = k * a.n + p0;
    const int cnt = (int)min((long long)PX, a.n - p0);
    const Bands bd = blend_bands(a, k);
    const float day_frac = a.day_time[k] / 24.0f;

    float v[PX][N_PLANES];
    if (a.vec) {                      // cnt == PX, every plane aligned
        const auto load4 = [&](int c) {
            const float4 q = *reinterpret_cast<const float4*>(a.plane[c] + at);
            v[0][c] = q.x;
            v[1][c] = q.y;
            v[2][c] = q.z;
            v[3][c] = q.w;
        };
        #pragma unroll
        for (int c = 0; c <= MW; ++c) load4(c);
        if (v[0][MW] != 0.0f || v[1][MW] != 0.0f || v[2][MW] != 0.0f
            || v[3][MW] != 0.0f) {
            #pragma unroll
            for (int c = MW + 1; c < N_PLANES; ++c) load4(c);
        }
    } else {
        #pragma unroll
        for (int j = 0; j < PX; ++j) {
            if (j < cnt) {
                #pragma unroll
                for (int c = 0; c <= MW; ++c) v[j][c] = a.plane[c][at + j];
                if (v[j][MW] != 0.0f) {
                    #pragma unroll
                    for (int c = MW + 1; c < N_PLANES; ++c)
                        v[j][c] = a.plane[c][at + j];
                }
            }
        }
    }

    uint8_t o[3 * PX];
    #pragma unroll
    for (int j = 0; j < PX; ++j)
        if (j < cnt) shade(a, bd, day_frac, v[j], o + 3 * j);

    uint8_t* out = a.out + 3 * at;
    if (a.vec) {
        uint32_t* w = reinterpret_cast<uint32_t*>(out);
        #pragma unroll
        for (int i = 0; i < 3; ++i)
            w[i] = (uint32_t)o[4 * i] | (uint32_t)o[4 * i + 1] << 8
                   | (uint32_t)o[4 * i + 2] << 16
                   | (uint32_t)o[4 * i + 3] << 24;
    } else {
        #pragma unroll
        for (int j = 0; j < PX; ++j) {
            if (j < cnt) {
                #pragma unroll
                for (int s = 0; s < 3; ++s) out[3 * j + s] = o[3 * j + s];
            }
        }
    }
}

}  // namespace

// Loads the kernel's module (lazy module loading defers it to the first
// launch otherwise, which must not fall inside a stream capture).
extern "C" int rt_sky_load() {
    cudaFuncAttributes attr;
    return (int)cudaFuncGetAttributes(&attr, sky_quantize_kernel);
}

// One launch on `stream` over K frames of h x w pixels: planes r, g, b, mw,
// mdx, mdy, mdz (K x h x w float32 each), the packed panoramas sky (4 x
// sky_h * sky_w int32), day_time (K) and sky_vars (K x 4) float32 → out (K
// x h x w x 3 uint8); every pointer on the device. half_pi, pi, two_pi and
// inv_255 are scene/textures.py's float32 constants.
extern "C" int rt_sky_quantize(
    const float* r, const float* g, const float* b, const float* mw,
    const float* mdx, const float* mdy, const float* mdz, const int* sky,
    int sky_h, int sky_w, const float* day_time, const float* sky_vars,
    int K, int h, int w, float half_pi, float pi, float two_pi,
    float inv_255, uint8_t* out, void* stream) {
    if (K < 1 || K > 65535 || h < 1 || w < 1 || sky_h < 1 || sky_w < 1
        || (long long)sky_h * sky_w > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    const long long n = (long long)h * w;
    const float* planes[N_PLANES] = {r, g, b, mw, mdx, mdy, mdz};
    bool vec = n % PX == 0 && (uintptr_t)out % 4 == 0;
    for (int c = 0; c < N_PLANES; ++c)
        vec = vec && (uintptr_t)planes[c] % 16 == 0;
    Args a{{r, g, b, mw, mdx, mdy, mdz}, sky, day_time, sky_vars, out, n,
           sky_h, sky_w, half_pi, pi, two_pi, inv_255, vec};
    const long long blocks = (n + (long long)THREADS * PX - 1)
                             / ((long long)THREADS * PX);
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)blocks, 1, K);
    sky_quantize_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

extern "C" const char* rt_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
