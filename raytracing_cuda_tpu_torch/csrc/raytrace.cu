// Raytracing megakernel for Hopper (sm_90a), one thread per pixel.
//
// Replaces the TPU megakernel raytracing_cuda_tpu/render/pallas_rt.py
// (_make_kernel, launched by raytrace_planes_batch at pallas_rt.py:1151).
// The Pallas kernel renders (48, 128) tiles and skips work per tile with
// lax.cond; here each thread traces one pixel as in the reference's
// `raytracing` kernel (kernel.cu:228-259): primary ray from the frustum
// corners, up to MAX_DEPTH + 1 levels, exit as soon as its own ray dies.
//
// Bound: arithmetic. Every level tests every scene row (brute force, no
// culls yet), ~30 flops per triangle row and ~20 per sphere row, plus one
// shadow sweep per light for shaded pixels; memory traffic is only the
// 7 output planes (28 bytes per pixel). The design keeps the scene table
// (params + coefficient rows, ~25 KB for the island) in shared memory,
// loaded once per block; all threads of a warp read the same row at the
// same time, so the reads are broadcasts without bank conflicts.
//
// Numerics follow the JAX kernel operation for operation: separate
// multiplies and adds (built with -fmad=false), IEEE division and sqrtf,
// 1/sqrtf where JAX uses rsqrt, and pow as exp2f(e * log2f(s)).
//
// Frames: blockIdx.z is the frame of a K-frame batch (the TPU kernel's
// leading grid axis, pallas_rt.py:1145-1171). Each block stages its own
// frame's params and coefficient rows; K = 1 is the single-frame launch.
//
// Output: out[7][K][H][W] float32 = r, g, b, miss weight, miss dir x, y, z.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_DEPTH = 4;
constexpr float BIG = 1e30f;

// coefficient-table channels (render/cuda_rt.py C_*)
constexpr int C_COL = 0;
constexpr int C_SHINE = 3;
constexpr int C_SPEC = 4;
constexpr int C_KR = 5;
constexpr int C_FLAGS = 6;
constexpr int C_CENTER = 8;
constexpr int C_NORMAL = 11;
constexpr int C_POS2 = 14;
constexpr int C_R2 = 15;
constexpr int C_CDET = 16;
constexpr int C_AU = 19;
constexpr int C_BU = 22;
constexpr int C_AV = 25;
constexpr int C_BV = 28;
constexpr int C_N = 31;
constexpr int C_V0N = 34;
constexpr int C_BLOCKS = 36;
constexpr int C_GIDX = 37;
constexpr int N_CHANNELS = 40;

// params slots (render/cuda_rt.py P_*)
constexpr int P_CAMPOS = 0;
constexpr int P_LD = 3;
constexpr int P_RD = 6;
constexpr int P_LU = 9;
constexpr int P_RU = 12;
constexpr int P_LPOS0 = 15;
constexpr int P_LPOS1 = 18;
constexpr int P_LCOL0 = 21;
constexpr int P_LCOL1 = 24;
constexpr int P_LINT = 27;
constexpr int P_AMBIENT = 29;
constexpr int P_SEAY = 32;
constexpr int N_PARAMS = 132;

constexpr int BLOCK_X = 16;
constexpr int BLOCK_Y = 16;

__device__ __forceinline__ float dot3(float ax, float ay, float az,
                                      float bx, float by, float bz) {
    return ax * bx + ay * by + az * bz;
}

// guarded normalize (pallas_rt.py:400-403)
__device__ __forceinline__ void norm3(float& x, float& y, float& z) {
    const float inv = 1.0f / sqrtf(fmaxf(x * x + y * y + z * z, 1e-20f));
    x = x * inv;
    y = y * inv;
    z = z * inv;
}

// Triangle t, BIG where rejected (pallas_rt.py:412-436). Pad rows have
// all-zero coefficients: det = 0 fails the det - 0.001 >= 0 test.
__device__ __forceinline__ float tri_t(const float* c, float ox, float oy,
                                       float oz, float dx, float dy, float dz,
                                       float mx, float my, float mz) {
    const float det = dot3(dx, dy, dz, c[C_CDET], c[C_CDET + 1], c[C_CDET + 2]);
    const float u_det = dot3(dx, dy, dz, c[C_AU], c[C_AU + 1], c[C_AU + 2])
                        + dot3(mx, my, mz, c[C_BU], c[C_BU + 1], c[C_BU + 2]);
    const float v_det = dot3(dx, dy, dz, c[C_AV], c[C_AV + 1], c[C_AV + 2])
                        - dot3(mx, my, mz, c[C_BV], c[C_BV + 1], c[C_BV + 2]);
    const float t_det = dot3(ox, oy, oz, c[C_N], c[C_N + 1], c[C_N + 2])
                        - c[C_V0N];
    const float acc = fminf(fminf(det - 0.001f, t_det),
                            fminf(fminf(u_det, v_det), det - u_det - v_det));
    return acc >= 0.0f ? t_det / det : BIG;
}

// Sphere t, BIG where rejected (pallas_rt.py:439-458); od = o.d, oo = o.o.
// Strict accept; pad rows carry r^2 = -1 and never pass it.
__device__ __forceinline__ float sph_t(const float* c, float ox, float oy,
                                       float oz, float dx, float dy, float dz,
                                       float od, float oo) {
    const float px = c[C_CENTER], py = c[C_CENTER + 1], pz = c[C_CENTER + 2];
    const float tca = dot3(dx, dy, dz, px, py, pz) - od;
    const float ll = c[C_POS2] - 2.0f * dot3(ox, oy, oz, px, py, pz) + oo;
    const float d2 = ll - tca * tca;
    const float r2 = c[C_R2];
    const float acc = fminf(tca, fminf(r2 - d2, d2 + 0.01f));
    return acc > 0.0f ? tca - sqrtf(fmaxf(r2 - d2, 0.0f)) : BIG;
}

// Sea plane t, BIG where missed (pallas_rt.py:461-465)
__device__ __forceinline__ float plane_t(float oy, float dy, float sea_y) {
    const float t = (sea_y - oy) / dy;
    return (dy * dy > 0.00001f && t >= 0.0f) ? t : BIG;
}

// Shadow ray from (ox, oy, oz) toward a light at distance sdist: occluded
// by the plane, any triangle or any blocking (non-emissive) sphere.
__device__ bool occluded(const float* C, int tri_end, int sph_end,
                         float sea_y, float ox, float oy, float oz, float dx,
                         float dy, float dz, float sdist) {
    if (plane_t(oy, dy, sea_y) < sdist) return true;
    const float mx = oy * dz - oz * dy;
    const float my = oz * dx - ox * dz;
    const float mz = ox * dy - oy * dx;
    for (int r = 1; r < tri_end; ++r) {
        if (tri_t(C + r * N_CHANNELS, ox, oy, oz, dx, dy, dz, mx, my, mz)
            < sdist) return true;
    }
    const float od = dot3(ox, oy, oz, dx, dy, dz);
    const float oo = dot3(ox, oy, oz, ox, oy, oz);
    for (int r = tri_end; r < sph_end; ++r) {
        const float* c = C + r * N_CHANNELS;
        if (c[C_BLOCKS] > 0.0f
            && sph_t(c, ox, oy, oz, dx, dy, dz, od, oo) < sdist) return true;
    }
    return false;
}

__global__ void __launch_bounds__(BLOCK_X * BLOCK_Y)
raytrace_kernel(const float* __restrict__ coef, int coef_rows, int n_rows,
                int tri_end, const float* __restrict__ params,
                float* __restrict__ out, int K, int H, int W, int row0,
                float inv_w1, float inv_h1) {
    extern __shared__ float smem[];
    float* P = smem;                 // N_PARAMS floats
    float* C = smem + N_PARAMS;      // n_rows x N_CHANNELS floats
    const int frame = blockIdx.z;
    const float* fparams = params + (size_t)frame * N_PARAMS;
    const float* fcoef = coef + (size_t)frame * coef_rows * N_CHANNELS;
    const int n_smem = N_PARAMS + n_rows * N_CHANNELS;
    for (int i = threadIdx.y * blockDim.x + threadIdx.x; i < n_smem;
         i += blockDim.x * blockDim.y) {
        smem[i] = i < N_PARAMS ? fparams[i] : fcoef[i - N_PARAMS];
    }
    __syncthreads();

    const int col = blockIdx.x * blockDim.x + threadIdx.x;
    const int row = blockIdx.y * blockDim.y + threadIdx.y;
    if (col >= W || row >= H) return;
    const int sph_end = n_rows;

    // primary ray (kernel.cu:244-253; pallas_rt.py:639-661)
    const float px = (float)col * inv_w1;
    const float py = (float)(row0 + row) * inv_h1;
    float dx, dy, dz;
    {
        const float vdx = P[P_LD] + (P[P_RD] - P[P_LD]) * px;
        const float vdy = P[P_LD + 1] + (P[P_RD + 1] - P[P_LD + 1]) * px;
        const float vdz = P[P_LD + 2] + (P[P_RD + 2] - P[P_LD + 2]) * px;
        const float vux = P[P_LU] + (P[P_RU] - P[P_LU]) * px;
        const float vuy = P[P_LU + 1] + (P[P_RU + 1] - P[P_LU + 1]) * px;
        const float vuz = P[P_LU + 2] + (P[P_RU + 2] - P[P_LU + 2]) * px;
        dx = vux - (vux - vdx) * py;
        dy = vuy - (vuy - vdy) * py;
        dz = vuz - (vuz - vdz) * py;
        norm3(dx, dy, dz);
    }
    float ox = P[P_CAMPOS], oy = P[P_CAMPOS + 1], oz = P[P_CAMPOS + 2];
    float thr = 1.0f, ra = 0.0f, ga = 0.0f, ba = 0.0f;
    float mw = 0.0f, mdx = dx, mdy = dy, mdz = dz;
    const float sea_y = P[P_SEAY];

    for (int level = 0; level <= MAX_DEPTH; ++level) {
        // nearest hit: lexicographic (t, gidx) minimum over the plane (gidx
        // 0) and every row — the TPU kernel's per-cluster reduce plus
        // cross-group combine (pallas_rt.py:527-540, 766-788)
        float best = plane_t(oy, dy, sea_y);
        float best_g = 0.0f;
        int best_row = 0;
        {
            const float mx = oy * dz - oz * dy;
            const float my = oz * dx - ox * dz;
            const float mz = ox * dy - oy * dx;
            for (int r = 1; r < tri_end; ++r) {
                const float* c = C + r * N_CHANNELS;
                const float t = tri_t(c, ox, oy, oz, dx, dy, dz, mx, my, mz);
                const float g = c[C_GIDX];
                if (t < BIG * 0.5f && (t < best || (t == best && g < best_g))) {
                    best = t;
                    best_g = g;
                    best_row = r;
                }
            }
        }
        {
            const float od = dot3(ox, oy, oz, dx, dy, dz);
            const float oo = dot3(ox, oy, oz, ox, oy, oz);
            for (int r = tri_end; r < sph_end; ++r) {
                const float* c = C + r * N_CHANNELS;
                const float t = sph_t(c, ox, oy, oz, dx, dy, dz, od, oo);
                const float g = c[C_GIDX];
                if (t < BIG * 0.5f && (t < best || (t == best && g < best_g))) {
                    best = t;
                    best_g = g;
                    best_row = r;
                }
            }
        }
        if (!(best < BIG * 0.5f)) {          // miss → deferred sky
            mw = thr;
            mdx = dx;
            mdy = dy;
            mdz = dz;
            break;
        }

        const float* wr = C + best_row * N_CHANNELS;
        const float colr = wr[C_COL], colg = wr[C_COL + 1], colb = wr[C_COL + 2];
        const float shine = wr[C_SHINE], spec_e = wr[C_SPEC], kr = wr[C_KR];
        const float flags = wr[C_FLAGS];
        const float hx = ox + dx * best, hy = oy + dy * best, hz = oz + dz * best;
        // flags = islight*2 + issph; the normal slot holds the static normal
        // for tris/plane and the center for spheres
        const bool em = flags >= 2.0f;
        const bool is_sph = (flags - 2.0f * (em ? 1.0f : 0.0f)) > 0.0f;
        float nx = wr[C_NORMAL], ny = wr[C_NORMAL + 1], nz = wr[C_NORMAL + 2];
        if (is_sph) {
            nx = hx - nx;
            ny = hy - ny;
            nz = hz - nz;
            norm3(nx, ny, nz);
        }
        if (em) {                            // emissive: add color, ray ends
            ra = ra + thr * colr;
            ga = ga + thr * colg;
            ba = ba + thr * colb;
            break;
        }

        // Phong with hard shadows (kernel.cu:169-205; pallas_rt.py:812-1062)
        float phr = colr * P[P_AMBIENT];
        float phg = colg * P[P_AMBIENT + 1];
        float phb = colb * P[P_AMBIENT + 2];
        for (int li = 0; li < 2; ++li) {
            const int pb = li == 0 ? P_LPOS0 : P_LPOS1;
            const int cb = li == 0 ? P_LCOL0 : P_LCOL1;
            const float lvx = P[pb] - hx, lvy = P[pb + 1] - hy,
                        lvz = P[pb + 2] - hz;
            const float sdist = sqrtf(lvx * lvx + lvy * lvy + lvz * lvz);
            const float inv = 1.0f / sdist;
            const float sdx = lvx * inv, sdy = lvy * inv, sdz = lvz * inv;
            float angle = fmaxf(0.0f, nx * sdx + ny * sdy + nz * sdz);
            if (angle > 0.0f
                && occluded(C, tri_end, sph_end, sea_y, hx + sdx * 0.001f,
                            hy + sdy * 0.001f, hz + sdz * 0.001f, sdx, sdy,
                            sdz, sdist)) {
                angle = 0.0f;
            }
            const float aint = angle * P[P_LINT + li];
            phr = phr + colr * P[cb] * aint;
            phg = phg + colg * P[cb + 1] * aint;
            phb = phb + colb * P[cb + 2] * aint;

            // specular: reflect -sdir about n (kernel.cu:198-205)
            const float ldn = -(sdx * nx + sdy * ny + sdz * nz);
            float spx = -sdx - 2.0f * ldn * nx;
            float spy = -sdy - 2.0f * ldn * ny;
            float spz = -sdz - 2.0f * ldn * nz;
            norm3(spx, spy, spz);
            const float sbase = fmaxf(0.0f, -(spx * dx + spy * dy + spz * dz));
            // pow(s, e) = exp2(e log2 s) for s > 0; pow(0, e) = 0 for e > 0,
            // 1 for e == 0 (pallas_rt.py:1045-1052)
            const float spec_pow = sbase > 0.0f
                ? exp2f(spec_e * log2f(fmaxf(sbase, 1e-30f)))
                : (spec_e > 0.0f ? 0.0f : 1.0f);
            const float spec = shine > 0.0f ? spec_pow * shine * angle : 0.0f;
            phr = phr + spec;
            phg = phg + spec;
            phb = phb + spec;
        }
        const float w = thr * (1.0f - kr);
        ra = ra + w * phr;
        ga = ga + w * phg;
        ba = ba + w * phb;

        if (!(kr > 0.0f)) break;             // only mirrors bounce
        // mirror bounce (kernel.cu:209-218)
        const float ddn = dx * nx + dy * ny + dz * nz;
        float rx = dx - 2.0f * ddn * nx;
        float ry = dy - 2.0f * ddn * ny;
        float rz = dz - 2.0f * ddn * nz;
        norm3(rx, ry, rz);
        ox = hx + rx * 0.001f;
        oy = hy + ry * 0.001f;
        oz = hz + rz * 0.001f;
        dx = rx;
        dy = ry;
        dz = rz;
        thr = thr * kr;
    }

    // plane p of frame f starts at (p * K + f) * H * W
    const size_t plane = (size_t)K * H * W;
    const size_t i = ((size_t)frame * H + row) * W + col;
    out[i] = ra;
    out[plane + i] = ga;
    out[2 * plane + i] = ba;
    out[3 * plane + i] = mw;
    out[4 * plane + i] = mdx;
    out[5 * plane + i] = mdy;
    out[6 * plane + i] = mdz;
}

}  // namespace

// coef: K x coef_rows x N_CHANNELS (rows n_rows.. are padding, never read);
// params: K x N_PARAMS; out: 7 x K x H x W.
extern "C" int rt_raytrace_planes(const float* coef, int coef_rows, int n_rows,
                                  int tri_end, int sph_end,
                                  const float* params, float* out, int K,
                                  int H, int W, int row0, float inv_w1,
                                  float inv_h1, void* stream) {
    if (sph_end != n_rows || tri_end < 1 || tri_end > n_rows
        || coef_rows < n_rows || K < 1 || K > 65535 || H < 1 || W < 1)
        return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)(N_PARAMS + n_rows * N_CHANNELS) * sizeof(float);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            raytrace_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const dim3 block(BLOCK_X, BLOCK_Y);
    const dim3 grid((W + BLOCK_X - 1) / BLOCK_X, (H + BLOCK_Y - 1) / BLOCK_Y,
                    K);
    raytrace_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
        coef, coef_rows, n_rows, tri_end, params, out, K, H, W, row0, inv_w1,
        inv_h1);
    return (int)cudaGetLastError();
}

extern "C" const char* rt_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
