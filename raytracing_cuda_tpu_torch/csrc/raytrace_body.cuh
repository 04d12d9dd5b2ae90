// Raytracing megakernel for Hopper (sm_90a): one thread per pixel, per-ray
// cluster culls, compact scene rows in shared memory, persistent blocks.
//
// Replaces the TPU megakernel raytracing_cuda_tpu/render/pallas_rt.py
// (_make_kernel, launched by raytrace_planes_batch at pallas_rt.py:1151).
// Each thread traces one pixel as in the reference's `raytracing` kernel
// (kernel.cu:228-259): primary ray from the frustum corners, up to
// MAX_DEPTH + 1 levels, exit as soon as its own ray dies.
//
// Bound: arithmetic. What a ray needs is the rows under the cluster bounds
// it can reach; memory traffic is only the 7 output planes (28 bytes per
// pixel). The design:
//   - Per-ray culls. The TPU kernel skips a cluster for a whole tile with
//     an interval test (_cluster_possible, pallas_rt.py:476-516, gated by
//     the plane-hit t-bound at :718-764 and by the light distance for
//     shadows at :862-872). Here each thread tests its own ray against each
//     bounding sphere with the float32 expression of render/cuda_rt.py
//     `reach`, operation for operation, so the CPU soundness tests of that
//     function speak for this kernel. A cast ray's t_hi starts at the sea
//     plane's hit and shrinks to the best hit so far (a bound with
//     tca - r > t holds no row that can win or tie); a shadow ray's is its
//     light distance, and groups with no blocking row are skipped. The sea
//     plane is tested first, so a light below the sea costs one plane test
//     (the TPU kernel's hcull, pallas_rt.py:873-902). A warp walks a
//     group's rows while any of its lanes needs them, so warps cover 8x4
//     pixel tiles, whose rays are close in origin and direction. Each block
//     visits its frame's groups nearest the camera first, so the island's
//     hits cull the mountain ring behind them.
//   - Compact rows. Staging repacks each triangle row into 5 float4s (the
//     20 floats its test reads) and each sphere row into 2, so a row test
//     issues 5 (2) 16-byte broadcast loads instead of 19 (6) scalar ones;
//     the 10 shading channels are read from the global table for the
//     winning row only.
//   - Persistent blocks. A launch has as many blocks per frame as the SMs
//     hold, divided among the K frames; each block stages its frame's
//     params and rows once, then each of its warps takes the frame's next
//     free warp tile from a counter until none is left: rays differ in
//     cost by an order of magnitude between sky and island, and the
//     counter keeps every warp busy to the end.
//
// Bit identity with the plain version (render/cuda_rt.py
// raytrace_planes_torch, brute force over every row): the nearest hit is
// the unique lexicographic (t, gidx) minimum over the plane and the rows, so
// skipping rows that cannot attain it leaves it unchanged, and a shadow ray
// is occluded iff some row under a reached group occludes it. Numerics
// follow the JAX kernel operation for operation: separate multiplies and
// adds (built with -fmad=false), IEEE division and sqrtf, 1/sqrtf where
// JAX uses rsqrt, and pow as exp2f(e * log2f(s)).
//
// Frames: blockIdx.y is the frame of a K-frame batch (the TPU kernel's
// leading grid axis, pallas_rt.py:1145-1171); K = 1 is the single-frame
// launch. row0/total_h place an H-row band in a frame of total_h rows.
//
// Counting launch: raytrace_kernel<true> is the same body that also counts,
// per warp, the row tests the warp executed (once per row test, whatever
// the number of lanes that needed it) and the row tests its lanes needed,
// for cast and for shadow rays. The main path never launches it.
//
// Diagnostic arms: raytrace_kernel<false, ARMS, DEPTH> with ARMS != 0 or
// DEPTH != MAX_DEPTH is a static variant of the body for cost
// decomposition (the TPU kernel's `ablate` arms, pallas_rt.py:559-584),
// launched only by csrc/raytrace_arms.cu. ARMS = 0, DEPTH = MAX_DEPTH is
// the shipped kernel: every arm test below folds away at compile time.
//
// Output: out[7][K][H][W] float32 = r, g, b, miss weight, miss dir x, y, z.
//
// This header holds the whole body; csrc/raytrace.cu (the shipped and the
// counting launch) and csrc/raytrace_arms.cu (the arms) each compile it
// into their own library.

#pragma once

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
constexpr int P_CLUSTERS = 36;       // MAX_CLUSTERS x (cx, cy, cz, r)
constexpr int MAX_CLUSTERS = 24;
constexpr int N_PARAMS = 132;
static_assert(N_PARAMS % 4 == 0 && P_CLUSTERS % 4 == 0, "float4 views");

constexpr int TILE_W = 8;            // a warp's pixel tile, TILE_W x TILE_H
constexpr int TILE_H = 4;
constexpr int WARPS = 4;             // warps per block
constexpr int THREADS = 32 * WARPS;
// blocks an SM must hold: caps ptxas at 65536 / (6 * 128) = 85 registers,
// above what the body needs, so it neither spills nor squeezes to 64
constexpr int MIN_BLOCKS = 6;
static_assert(TILE_W * TILE_H == 32, "a warp tile holds 32 pixels");

constexpr int TRI_F4 = 5;            // float4s per compact triangle row
constexpr int SPH_F4 = 2;            // float4s per compact sphere row

// counters of the counting launch
enum { CAST_WARP, CAST_LANE, SHADOW_WARP, SHADOW_LANE, N_COUNTS };

// The diagnostic arms, bits of ARMS (render/cuda_rt.py ARM_*).
enum : int {
    ARM_NOSHADOW = 1,    // lights are never blocked: no shadow ray is cast
    ARM_NOSHADE = 2,     // a hit ends the ray and adds nothing
    ARM_NOCULL = 4,      // no per-ray cluster cull: every group's rows
    ARM_NO_TBOUND = 8,   // the culls' t_hi is BIG for cast and shadow rays
    ARM_NOHCULL = 16,    // a shadow ray tests the sea plane after the groups
};
static_assert(THREADS >= MAX_CLUSTERS, "one thread per group at staging");

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

// A cull group in shared memory: its bound (cx, cy, cz, r) and its rows
// (first, end, whether it holds a blocking row, whether it holds
// triangles).
struct Group {
    float4 b;
    int4 rows;
};

// The frame's scene in shared memory: params, compact rows and the cull
// groups in visiting order.
struct Tables {
    const float* P;
    const float4* tri;               // row r at tri + (r - 1) * TRI_F4
    const float4* sph;               // row r at sph + (r - tri_end) * SPH_F4
    const Group* groups;
    int n_groups;
    int tri_end;
};

// Per-thread tallies of the counting launch (empty otherwise). A row test
// counts 1 for the lane that needed it and, without a branch (which would
// split the warp it measures), 1 for the warp from the lowest lane
// executing it.
template <bool COUNT>
struct Tally {
    unsigned n[N_COUNTS] = {};
    __device__ __forceinline__ void row(int warp_slot) {
        ++n[warp_slot + 1];
        n[warp_slot] += (int)(threadIdx.x & 31) == __ffs(__activemask()) - 1;
    }
};

template <>
struct Tally<false> {
    __device__ __forceinline__ void row(int) {}
};

// The cluster cull of render/cuda_rt.py `reach`, operation for operation:
// can the ray meet the bounding sphere b = (c, r) before distance t_hi?
__device__ __forceinline__ bool reach(float4 b, float ox, float oy, float oz,
                                      float dx, float dy, float dz,
                                      float t_hi) {
    const float lx = b.x - ox, ly = b.y - oy, lz = b.z - oz;
    const float ll = lx * lx + ly * ly + lz * lz;
    const float tca = lx * dx + ly * dy + lz * dz;
    const float r2 = b.w * b.w;
    return ll <= r2
           || (tca > 0.0f && ll - tca * tca <= r2 && tca - b.w <= t_hi);
}

// Triangle t, BIG where rejected (pallas_rt.py:412-436), from a compact row:
// q0 = (cdet, v0n), q1 = (au, gidx), q2 = (bu, bv.x), q3 = (av, bv.y),
// q4 = (n, bv.z). Pad rows have all-zero coefficients: det = 0 fails the
// det - 0.001 >= 0 test.
__device__ __forceinline__ float tri_t(const float4* q, float ox, float oy,
                                       float oz, float dx, float dy, float dz,
                                       float mx, float my, float mz) {
    const float4 a = q[0], b = q[1], c = q[2], d = q[3], e = q[4];
    const float det = dot3(dx, dy, dz, a.x, a.y, a.z);
    const float u_det = dot3(dx, dy, dz, b.x, b.y, b.z)
                        + dot3(mx, my, mz, c.x, c.y, c.z);
    const float v_det = dot3(dx, dy, dz, d.x, d.y, d.z)
                        - dot3(mx, my, mz, c.w, d.w, e.w);
    const float t_det = dot3(ox, oy, oz, e.x, e.y, e.z) - a.w;
    const float acc = fminf(fminf(det - 0.001f, t_det),
                            fminf(fminf(u_det, v_det), det - u_det - v_det));
    return acc >= 0.0f ? t_det / det : BIG;
}

// Sphere t, BIG where rejected (pallas_rt.py:439-458), from a compact row:
// q0 = (center, |center|^2), q1 = (r^2, blocks, gidx, 0); od = o.d,
// oo = o.o. Strict accept; pad rows carry r^2 = -1 and never pass it.
__device__ __forceinline__ float sph_t(const float4* q, float ox, float oy,
                                       float oz, float dx, float dy, float dz,
                                       float od, float oo) {
    const float4 p = q[0];
    const float tca = dot3(dx, dy, dz, p.x, p.y, p.z) - od;
    const float ll = p.w - 2.0f * dot3(ox, oy, oz, p.x, p.y, p.z) + oo;
    const float d2 = ll - tca * tca;
    const float r2 = q[1].x;
    const float acc = fminf(tca, fminf(r2 - d2, d2 + 0.01f));
    return acc > 0.0f ? tca - sqrtf(fmaxf(r2 - d2, 0.0f)) : BIG;
}

// Sea plane t, BIG where missed (pallas_rt.py:461-465)
__device__ __forceinline__ float plane_t(float oy, float dy, float sea_y) {
    const float t = (sea_y - oy) / dy;
    return (dy * dy > 0.00001f && t >= 0.0f) ? t : BIG;
}

// Nearest hit of a cast ray: the lexicographic (t, gidx) minimum over the
// plane (gidx 0) and the rows of every group the ray reaches → its t (BIG
// on a miss) and table row (0 for the plane).
template <bool COUNT, int ARMS>
__device__ __forceinline__ float nearest(const Tables& s, float ox, float oy,
                                         float oz, float dx, float dy,
                                         float dz, int& best_row,
                                         Tally<COUNT>& tally) {
    float best = plane_t(oy, dy, s.P[P_SEAY]);
    float best_g = 0.0f;
    best_row = 0;
    const float mx = oy * dz - oz * dy;
    const float my = oz * dx - ox * dz;
    const float mz = ox * dy - oy * dx;
    const float od = dot3(ox, oy, oz, dx, dy, dz);
    const float oo = dot3(ox, oy, oz, ox, oy, oz);
    for (int g = 0; g < s.n_groups; ++g) {
        if (!(ARMS & ARM_NOCULL)
            && !reach(s.groups[g].b, ox, oy, oz, dx, dy, dz,
                      (ARMS & ARM_NO_TBOUND) ? BIG : best))
            continue;
        const int4 gr = s.groups[g].rows;
        if (gr.w) {
            for (int r = gr.x; r < gr.y; ++r) {
                tally.row(CAST_WARP);
                const float4* q = s.tri + (r - 1) * TRI_F4;
                const float t = tri_t(q, ox, oy, oz, dx, dy, dz, mx, my, mz);
                const float gi = q[1].w;
                if (t < BIG * 0.5f && (t < best || (t == best && gi < best_g))) {
                    best = t;
                    best_g = gi;
                    best_row = r;
                }
            }
        } else {
            for (int r = gr.x; r < gr.y; ++r) {
                tally.row(CAST_WARP);
                const float4* q = s.sph + (r - s.tri_end) * SPH_F4;
                const float t = sph_t(q, ox, oy, oz, dx, dy, dz, od, oo);
                const float gi = q[1].z;
                if (t < BIG * 0.5f && (t < best || (t == best && gi < best_g))) {
                    best = t;
                    best_g = gi;
                    best_row = r;
                }
            }
        }
    }
    return best;
}

// Shadow ray from (ox, oy, oz) toward a light at distance sdist: occluded
// by the plane, or by a triangle or blocking (non-emissive) sphere under a
// blocking group the ray reaches before the light. The plane goes first
// (below-sea lights cost one test) unless the arm ARM_NOHCULL moves it
// after the groups.
template <bool COUNT, int ARMS>
__device__ bool occluded(const Tables& s, float ox, float oy, float oz,
                         float dx, float dy, float dz, float sdist,
                         Tally<COUNT>& tally) {
    if (!(ARMS & ARM_NOHCULL) && plane_t(oy, dy, s.P[P_SEAY]) < sdist)
        return true;
    const float mx = oy * dz - oz * dy;
    const float my = oz * dx - ox * dz;
    const float mz = ox * dy - oy * dx;
    const float od = dot3(ox, oy, oz, dx, dy, dz);
    const float oo = dot3(ox, oy, oz, ox, oy, oz);
    for (int g = 0; g < s.n_groups; ++g) {
        const int4 gr = s.groups[g].rows;
        if (!gr.z
            || (!(ARMS & ARM_NOCULL)
                && !reach(s.groups[g].b, ox, oy, oz, dx, dy, dz,
                          (ARMS & ARM_NO_TBOUND) ? BIG : sdist)))
            continue;
        if (gr.w) {
            for (int r = gr.x; r < gr.y; ++r) {
                tally.row(SHADOW_WARP);
                if (tri_t(s.tri + (r - 1) * TRI_F4, ox, oy, oz, dx, dy, dz,
                          mx, my, mz) < sdist) return true;
            }
        } else {
            for (int r = gr.x; r < gr.y; ++r) {
                const float4* q = s.sph + (r - s.tri_end) * SPH_F4;
                if (!(q[1].y > 0.0f)) continue;
                tally.row(SHADOW_WARP);
                if (sph_t(q, ox, oy, oz, dx, dy, dz, od, oo) < sdist)
                    return true;
            }
        }
    }
    return (ARMS & ARM_NOHCULL) && plane_t(oy, dy, s.P[P_SEAY]) < sdist;
}

// One pixel's ray tree, levels 0..DEPTH → its 7 plane values.
template <bool COUNT, int ARMS, int DEPTH>
__device__ __forceinline__ void trace(const Tables& s,
                                      const float* __restrict__ fcoef,
                                      float px, float py, float* v,
                                      Tally<COUNT>& tally) {
    const float* P = s.P;
    // primary ray (kernel.cu:244-253; pallas_rt.py:639-661)
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

    for (int level = 0; level <= DEPTH; ++level) {
        int best_row;
        const float best = nearest<COUNT, ARMS>(s, ox, oy, oz, dx, dy, dz,
                                                best_row, tally);
        if (!(best < BIG * 0.5f)) {          // miss → deferred sky
            mw = thr;
            mdx = dx;
            mdy = dy;
            mdz = dz;
            break;
        }
        if (ARMS & ARM_NOSHADE) break;       // the hit adds nothing

        // the winner's shading channels, from the global table
        const float* wr = fcoef + best_row * N_CHANNELS;
        const float colr = __ldg(wr + C_COL), colg = __ldg(wr + C_COL + 1),
                    colb = __ldg(wr + C_COL + 2);
        const float shine = __ldg(wr + C_SHINE), spec_e = __ldg(wr + C_SPEC),
                    kr = __ldg(wr + C_KR);
        const float flags = __ldg(wr + C_FLAGS);
        const float hx = ox + dx * best, hy = oy + dy * best, hz = oz + dz * best;
        // flags = islight*2 + issph; the normal slot holds the static normal
        // for tris/plane and the center for spheres
        const bool em = flags >= 2.0f;
        const bool is_sph = (flags - 2.0f * (em ? 1.0f : 0.0f)) > 0.0f;
        float nx = __ldg(wr + C_NORMAL), ny = __ldg(wr + C_NORMAL + 1),
              nz = __ldg(wr + C_NORMAL + 2);
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
            if (!(ARMS & ARM_NOSHADOW) && angle > 0.0f
                && occluded<COUNT, ARMS>(s, hx + sdx * 0.001f,
                                         hy + sdy * 0.001f, hz + sdz * 0.001f,
                                         sdx, sdy, sdz, sdist, tally)) {
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
    v[0] = ra;
    v[1] = ga;
    v[2] = ba;
    v[3] = mw;
    v[4] = mdx;
    v[5] = mdy;
    v[6] = mdz;
}

__host__ __device__ constexpr int smem_floats(int n_tri, int n_sph) {
    return N_PARAMS + 4 * (TRI_F4 * n_tri + SPH_F4 * n_sph);
}

template <bool COUNT, int ARMS, int DEPTH>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
raytrace_kernel(const float* __restrict__ coef, int coef_rows, int n_rows,
                int tri_end, const float* __restrict__ params,
                const int* __restrict__ cull, int n_groups,
                float* __restrict__ out, int K, int H, int W, int row0,
                float inv_w1, float inv_h1, int* __restrict__ tile_next,
                unsigned long long* __restrict__ counts) {
    extern __shared__ float4 smem[];
    const int frame = blockIdx.y;
    const float* fparams = params + (size_t)frame * N_PARAMS;
    const float* fcoef = coef + (size_t)frame * coef_rows * N_CHANNELS;
    const int n_tri = tri_end - 1, n_sph = n_rows - tri_end;
    float* P = reinterpret_cast<float*>(smem);
    float4* tri = smem + N_PARAMS / 4;
    float4* sph = tri + n_tri * TRI_F4;
    __shared__ Group groups[MAX_CLUSTERS], unsorted[MAX_CLUSTERS];

    // stage this frame's params, compact rows and groups, once per block
    for (int i = threadIdx.x; i < N_PARAMS; i += THREADS) P[i] = fparams[i];
    for (int r = threadIdx.x; r < n_tri; r += THREADS) {
        const float* c = fcoef + (size_t)(1 + r) * N_CHANNELS;
        float4* q = tri + r * TRI_F4;
        q[0] = make_float4(c[C_CDET], c[C_CDET + 1], c[C_CDET + 2], c[C_V0N]);
        q[1] = make_float4(c[C_AU], c[C_AU + 1], c[C_AU + 2], c[C_GIDX]);
        q[2] = make_float4(c[C_BU], c[C_BU + 1], c[C_BU + 2], c[C_BV]);
        q[3] = make_float4(c[C_AV], c[C_AV + 1], c[C_AV + 2], c[C_BV + 1]);
        q[4] = make_float4(c[C_N], c[C_N + 1], c[C_N + 2], c[C_BV + 2]);
    }
    for (int r = threadIdx.x; r < n_sph; r += THREADS) {
        const float* c = fcoef + (size_t)(tri_end + r) * N_CHANNELS;
        float4* q = sph + r * SPH_F4;
        q[0] = make_float4(c[C_CENTER], c[C_CENTER + 1], c[C_CENTER + 2],
                           c[C_POS2]);
        q[1] = make_float4(c[C_R2], c[C_BLOCKS], c[C_GIDX], 0.0f);
    }
    if (threadIdx.x < n_groups) {
        // rows clamped into the group's part of the table: a malformed
        // group cannot read outside shared memory
        const int g = threadIdx.x;
        const int first = cull[3 * g], cnt = cull[3 * g + 1];
        const int is_tri = first < tri_end;
        const int lo = is_tri ? 1 : tri_end, hi = is_tri ? tri_end : n_rows;
        const int f = min(max(first, lo), hi);
        const float4 b = reinterpret_cast<const float4*>(
            fparams + P_CLUSTERS)[g];
        unsorted[g] = Group{b, make_int4(f, min(max(first + cnt, f), hi),
                                         cull[3 * g + 2] != 0, is_tri)};
    }
    __syncthreads();
    if (threadIdx.x < n_groups) {
        // near groups first, so a cast ray's shrinking t_hi culls the far
        // ones: each group's rank is the number of groups whose bound's near
        // side lies closer to the camera, ties by index (NaN counts as BIG)
        const int g = threadIdx.x;
        const auto key = [&](int j) {
            const float4 b = unsorted[j].b;
            const float cx = b.x - P[P_CAMPOS], cy = b.y - P[P_CAMPOS + 1],
                        cz = b.z - P[P_CAMPOS + 2];
            return fminf(sqrtf(cx * cx + cy * cy + cz * cz) - b.w, BIG);
        };
        const float kg = key(g);
        int rank = 0;
        for (int j = 0; j < n_groups; ++j) {
            const float kj = key(j);
            rank += kj < kg || (kj == kg && j < g);
        }
        groups[rank] = unsorted[g];
    }
    __syncthreads();

    const Tables s{P, tri, sph, groups, n_groups, tri_end};
    const int lane = threadIdx.x & 31;
    Tally<COUNT> tally;
    const int tiles_x = (W + TILE_W - 1) / TILE_W;
    const int n_tiles = tiles_x * ((H + TILE_H - 1) / TILE_H);
    // plane p of frame f starts at (p * K + f) * H * W
    const size_t plane = (size_t)K * H * W;
    // lane 0 takes the warp's next tile from the frame's counter
    int* counter = tile_next + frame;
    for (;;) {
        const int t = __shfl_sync(0xffffffffu,
                                  lane ? 0 : atomicAdd(counter, 1), 0);
        if (t >= n_tiles) break;
        const int col = (t % tiles_x) * TILE_W + lane % TILE_W;
        const int row = (t / tiles_x) * TILE_H + lane / TILE_W;
        if (col < W && row < H) {
            float v[7];
            trace<COUNT, ARMS, DEPTH>(s, fcoef, (float)col * inv_w1,
                                      (float)(row0 + row) * inv_h1, v, tally);
            const size_t i = ((size_t)frame * H + row) * W + col;
#pragma unroll
            for (int p = 0; p < 7; ++p) out[p * plane + i] = v[p];
        }
    }

    if constexpr (COUNT) {
#pragma unroll
        for (int k = 0; k < N_COUNTS; ++k) {
            unsigned long long n = tally.n[k];
            for (int o = 16; o > 0; o >>= 1)
                n += __shfl_down_sync(0xffffffffu, n, o);
            if (lane == 0) atomicAdd(counts + k, n);
        }
    }
}

// Checks the arguments, sizes the persistent grid, zeroes the tile
// counters and launches raytrace_kernel<COUNT, ARMS, DEPTH> → a
// cudaError_t. The arguments are those of rt_raytrace_planes (raytrace.cu).
template <bool COUNT, int ARMS = 0, int DEPTH = MAX_DEPTH>
int launch(const float* coef, int coef_rows, int n_rows, int tri_end,
           int sph_end, const float* params, const int* cull, int n_groups,
           float* out, int K, int H, int W, int row0, float inv_w1,
           float inv_h1, int* tile_next, unsigned long long* counts,
           void* stream) {
    if (sph_end != n_rows || tri_end < 1 || tri_end > n_rows
        || coef_rows < n_rows || n_groups < 1 || n_groups > MAX_CLUSTERS
        || K < 1 || K > 65535 || H < 1 || W < 1 || !tile_next
        || (COUNT && !counts))
        return (int)cudaErrorInvalidValue;
    const auto kernel = raytrace_kernel<COUNT, ARMS, DEPTH>;
    const size_t smem =
        (size_t)smem_floats(tri_end - 1, n_rows - tri_end) * sizeof(float);
    cudaError_t e;
    if (smem > 48 * 1024) {
        e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    // persistent blocks: what the SMs hold at once, shared among the frames
    int dev, sms, per_sm;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess
        || (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                       dev)) != cudaSuccess
        || (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, kernel, THREADS, smem)) != cudaSuccess)
        return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    const int tiles = ((W + TILE_W - 1) / TILE_W) * ((H + TILE_H - 1) / TILE_H);
    const int resident = sms * per_sm / K, needed = (tiles + WARPS - 1) / WARPS;
    const int per_frame =
        resident < 1 ? 1 : resident < needed ? resident : needed;
    if ((e = cudaMemsetAsync(tile_next, 0, K * sizeof(int),
                             (cudaStream_t)stream)) != cudaSuccess)
        return (int)e;
    raytrace_kernel<COUNT, ARMS, DEPTH><<<dim3(per_frame, K), THREADS, smem,
                                          (cudaStream_t)stream>>>(
        coef, coef_rows, n_rows, tri_end, params, cull, n_groups, out, K, H,
        W, row0, inv_w1, inv_h1, tile_next, counts);
    return (int)cudaGetLastError();
}

}  // namespace
