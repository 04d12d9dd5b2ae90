// FXAA post-pass for Hopper (sm_90a): a shared-memory tile per block.
//
// Replaces the TPU kernel raytracing_cuda_tpu/render/fxaa.py
// (_make_fxaa_kernel, launched by fxaa_ext_pallas at fxaa.py:265), which
// holds a packed-int32 frame in VMEM and computes every tap of a 3x3
// stencil per (16, 256) tile.
//
// Bound: neither, by far. Per pixel it reads 3 bytes and writes 3, with
// ~140 float operations: at 1280x720, 5.5 MB of DRAM traffic (1.65 us at
// 3.35 TB/s) and ~0.13 GFLOP (~1.9 us at 67 TFLOP/s). What costs is
// instructions per pixel, so the design does each piece of work once:
//   - a block stages its TILE_W x TILE_H output tile plus a 1-pixel halo
//     into shared memory with 16-byte loads where rows are 16-byte aligned
//     (a 720p row is 3,840 bytes), and byte loads at ragged edges and odd
//     widths;
//   - each luminance is computed once into a shared float tile (a 3x3
//     stencil would otherwise compute each one 9 times, from 3 byte loads
//     each);
//   - the stencil reads the shared tiles and stops at the contrast test
//     where a pixel is no edge (most of a frame), so the blend factor and
//     edge pick run only where they change a pixel;
//   - the block stages its output in shared memory and writes it back
//     with 16-byte stores.
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
// (params row0/total_h, fxaa.py:218-224). A row is staged only where its
// global row lies in the frame, so halo contents at the frame's top and
// bottom are never read. A whole frame is the band h = total_h, row0 = 0
// with no halo: no copy is added to the main path's launch.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int TILE_W = 64;           // output pixels per block row
constexpr int TILE_H = 8;            // output rows per block
constexpr int THREADS = 256;
constexpr int PAD = 16;              // staged bytes left of the tile
// a staged row: PAD bytes (the left halo pixel in its last 3), the tile's
// 3 * TILE_W bytes, then 16 more (the right halo pixel in its first 3)
constexpr int IN_BYTES = PAD + 3 * TILE_W + 16;
constexpr int OUT_BYTES = 3 * TILE_W;
static_assert(IN_BYTES % 16 == 0 && OUT_BYTES % 16 == 0, "16-byte chunks");

// Luminance rounded as XLA compiles the JAX package's stencil (the
// arithmetic that wrote the golden frames): explicit fmaf, then a multiply
// by f32(1/255). See render/fxaa.py `luminance` for why not a true divide.
__device__ __forceinline__ float lum(const uint8_t* p) {
    const float r = p[0], g = p[1], b = p[2];
    const float s = fmaf(b, 0.0721750f, fmaf(r, 0.2126729f, g * 0.7151522f));
    return fminf(255.0f, s) * (1.0f / 255.0f);
}

__global__ void __launch_bounds__(THREADS)
fxaa_kernel(const uint8_t* __restrict__ bands_in, size_t in_stride,
            uint8_t* __restrict__ frames_out, int h, int W, int row0,
            int total_h) {
    __shared__ __align__(16) uint8_t in_t[TILE_H + 2][IN_BYTES];
    __shared__ float lum_t[TILE_H + 2][TILE_W + 2];
    __shared__ __align__(16) uint8_t out_t[TILE_H][OUT_BYTES];

    // `in` is band row 0 of this frame; an interior pixel reads rows y - 1
    // and y + 1, which lie in the halo rows at the band's edges
    const uint8_t* __restrict__ in = bands_in + (size_t)blockIdx.z * in_stride;
    uint8_t* __restrict__ out = frames_out + (size_t)blockIdx.z * h * W * 3;
    const int x0 = blockIdx.x * TILE_W, y0 = blockIdx.y * TILE_H;
    const int row_bytes = 3 * W;
    // 16-byte accesses need 16-byte aligned rows in and out
    const bool vec = row_bytes % 16 == 0 && in_stride % 16 == 0
                     && (uintptr_t)bands_in % 16 == 0
                     && (uintptr_t)frames_out % 16 == 0;

    // stage rows y0 - 1 .. y0 + TILE_H of the band (zeros where a row lies
    // outside the band's rows or the frame), bytes from 3 * x0 - PAD
    for (int i = threadIdx.x; i < (TILE_H + 2) * (IN_BYTES / 16);
         i += THREADS) {
        const int ly = i / (IN_BYTES / 16), q = i % (IN_BYTES / 16);
        const int y = y0 - 1 + ly, gy = row0 + y;
        const int b = 3 * x0 - PAD + 16 * q;
        uint8_t* dst = &in_t[ly][16 * q];
        const bool row_ok = y <= h && gy >= 0 && gy < total_h;
        const uint8_t* src = in + (ptrdiff_t)y * row_bytes + b;
        if (row_ok && vec && b >= 0 && b + 16 <= row_bytes) {
            *reinterpret_cast<uint4*>(dst) =
                __ldg(reinterpret_cast<const uint4*>(src));
        } else {
            for (int j = 0; j < 16; ++j)
                dst[j] = row_ok && b + j >= 0 && b + j < row_bytes ? src[j] : 0;
        }
    }
    __syncthreads();

    // each staged pixel's luminance, once
    for (int i = threadIdx.x; i < (TILE_H + 2) * (TILE_W + 2); i += THREADS) {
        const int ly = i / (TILE_W + 2), lx = i % (TILE_W + 2) - 1;
        lum_t[ly][lx + 1] = lum(&in_t[ly][PAD + 3 * lx]);
    }
    __syncthreads();

    for (int i = threadIdx.x; i < TILE_H * TILE_W; i += THREADS) {
        const int ty = i / TILE_W, tx = i % TILE_W;
        const int x = x0 + tx, y = y0 + ty;
        if (x >= W || y >= h) continue;
        const int gy = row0 + y;             // the pixel's row in its frame
        bool use_aa = x > 0 && gy > 0 && x < W - 1 && gy < total_h - 1;
        // shared-tile coordinates of the pixel: row ty + 1, column tx + 1
        int nb_y = ty + 1, nb_x = tx;
        float blend = 0.0f;
        if (use_aa) {
            const float* up = lum_t[ty] + tx + 1;
            const float* mid = lum_t[ty + 1] + tx + 1;
            const float* dn = lum_t[ty + 2] + tx + 1;
            const float lm = mid[0];
            const float ln = up[0];
            const float ls = dn[0];
            const float le = mid[1];
            const float lw = mid[-1];

            const float high = fmaxf(fmaxf(fmaxf(fmaxf(le, lw), ln), ls), lm);
            const float low = fminf(fminf(fminf(fminf(le, lw), ln), ls), lm);
            const float contrast = high - low;
            use_aa = !(contrast < fmaxf(0.0312f, 0.063f * high));
            if (use_aa) {                    // an edge: blend factor, pick
                const float lne = up[1];
                const float lnw = up[-1];
                const float lse = dn[1];
                const float lsw = dn[-1];
                float filt = (2.0f * (le + lw + ls + ln) + lne + lnw + lse
                              + lsw) / 12.0f;
                filt = fminf(1.0f, fabsf(filt - lm) / contrast);
                blend = filt * filt * (3.0f - 2.0f * filt);

                const float hor = fabsf(ln + ls - 2.0f * lm) * 2.0f
                                  + fabsf(lne + lse - 2.0f * le)
                                  + fabsf(lnw + lsw - 2.0f * lw);
                const float ver = fabsf(le + lw - 2.0f * lm) * 2.0f
                                  + fabsf(lne + lnw - 2.0f * ln)
                                  + fabsf(lse + lsw - 2.0f * ls);
                if (hor >= ver) {
                    nb_y = fabsf(ln - lm) >= fabsf(ls - lm) ? ty : ty + 2;
                } else {
                    nb_x = fabsf(le - lm) >= fabsf(lw - lm) ? tx + 1 : tx - 1;
                }
            }
        }
        const uint8_t* cm = &in_t[ty + 1][PAD + 3 * tx];
        const uint8_t* nb = &in_t[nb_y][PAD + 3 * nb_x];
        for (int c = 0; c < 3; ++c) {
            if (use_aa) {
                const float v = (float)nb[c] * blend
                                + (float)cm[c] * (1.0f - blend);
                out_t[ty][3 * tx + c] = (uint8_t)fminf(fmaxf(v, 0.0f), 255.0f);
            } else {
                out_t[ty][3 * tx + c] = cm[c];
            }
        }
    }
    __syncthreads();

    // write the tile's rows back, 16 bytes at a time where aligned
    for (int i = threadIdx.x; i < TILE_H * (OUT_BYTES / 16); i += THREADS) {
        const int ty = i / (OUT_BYTES / 16), q = i % (OUT_BYTES / 16);
        const int y = y0 + ty, b = 3 * x0 + 16 * q;
        if (y >= h || b >= row_bytes) continue;
        uint8_t* dst = out + (size_t)y * row_bytes + b;
        const uint8_t* src = &out_t[ty][16 * q];
        if (vec && b + 16 <= row_bytes) {
            *reinterpret_cast<uint4*>(dst) =
                *reinterpret_cast<const uint4*>(src);
        } else {
            for (int j = 0; j < 16 && b + j < row_bytes; ++j) dst[j] = src[j];
        }
    }
}

}  // namespace

// bands_in: K frames' band row 0, frame k at bands_in + k * in_stride bytes;
// band rows -1 and h (the halo rows) are read only where their global rows
// lie in the frame. out: K x h x W x 3 uint8. A whole frame is h = total_h,
// row0 = 0, in_stride = h * W * 3: its border rows pass through and no halo
// is read.
extern "C" int rt_fxaa(const uint8_t* bands_in, size_t in_stride,
                       uint8_t* out, int K, int h, int W, int row0,
                       int total_h, void* stream) {
    if (K < 1 || K > 65535 || h < 1 || W < 1 || row0 < 0
        || row0 + h > total_h)
        return (int)cudaErrorInvalidValue;
    const dim3 grid((W + TILE_W - 1) / TILE_W, (h + TILE_H - 1) / TILE_H, K);
    fxaa_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        bands_in, in_stride, out, h, W, row0, total_h);
    return (int)cudaGetLastError();
}

extern "C" const char* rt_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
