// The frame's packs for Hopper (sm_90a): one launch of one block writes a
// frame's coefficient table and params vector (render/pipeline.py
// `frame_packs` on a card, through render/packs.py `pack_frame`).
//
// Replaces no TPU kernel: the JAX package builds its packs with XLA ops
// inside its jitted step (render/pallas_rt.py:1226-1254). The port's torch
// version of the same packs (pipeline.frame_packs_torch) is some 540 small
// kernels a frame, about 1.5 us each, for 24 KB of output.
//
// Bound: neither. A launch reads the base (152 x 40 floats for the island)
// and writes as much: about 49 KB, 15 ns at 3.35 TB/s. What costs is the
// launch and the serial chain of a few dozen scalar operations. The design:
//   - The base (render/packs.py `pack_base`) is packed once per scene
//     layout and device, outside any graph: every triangle row's
//     coefficients, the static colours and flags, the pad rows, the
//     triangle bounds and the static sphere-cluster bounds, and, as data,
//     what moves: each row's colour class, the rows of the two light
//     proxies and the sphere clusters whose bound holds a light. The
//     launch copies it and recomputes only those entries, so the island
//     and the classic scene run the same code.
//   - Three warps compute the frame's scalars at once (the palettes, the
//     lights, the camera corners) into shared memory while every thread
//     copies the base; after one barrier the threads write the colours of
//     the classed rows, one lane the params, one the light rows and the
//     moving bounds.
//
// Bit identity with the torch version on the same card: every operation is
// the torch code's, in its order, each rounded on its own (built with
// -fmad=false, as torch's separate elementwise kernels are), divisions and
// square roots IEEE (true_div, torch.sqrt), and cosf/sinf/tanf/fmodf, which
// torch's CUDA kernels call for float32. Scalars that the torch code
// multiplies by are converted from their Python doubles, as torch does.

#include <cuda_runtime.h>
#include <math.h>

namespace {

// render/cuda_rt.py's channel and params maps (the entries written here)
constexpr int C_COL = 0;
constexpr int C_CENTER = 8;
constexpr int C_NORMAL = 11;
constexpr int C_POS2 = 14;
constexpr int N_CHANNELS = 40;
constexpr int P_CAMPOS = 0;
constexpr int P_LD = 3;
constexpr int P_LPOS0 = 15;
constexpr int P_LCOL0 = 21;
constexpr int P_AMBIENT = 29;
constexpr int P_SEAY = 32;
constexpr int P_CLUSTERS = 36;
constexpr int N_PARAMS = 132;

// render/packs.py's colour classes of a row (0: static)
constexpr int N_PALETTES = 4;        // tree, mountain, lake; then ambient

constexpr int THREADS = 256;

struct Args {
    const float* base_coef;          // n_rows x N_CHANNELS
    const float* base_params;        // N_PARAMS
    const int* row_class;            // n_rows: 0 static, 1 + palette
    const float* sph_r;              // n_rows: a sphere row's radius
    const int* moving;               // n_moving x (first row, rows, bound)
    int n_rows;
    int n_moving;
    int light0, light1;              // the sun's and the moon's rows
    // the state (sim/state.py FrameState)
    const float* cam_pos;            // 3
    const float* hor;
    const float* ver;
    const float* fov;
    const float* day_time;
    const float* sea_y;
    const float* recolor;            // 4: the recolour weights
    // the step's constants (sim/state.py device_constants)
    const float* palette[N_PALETTES];  // 4 x 3 each
    const float* tilt;
    const float* offset;             // 3
    float aspect;                    // float32(width / height)
    float deg;                       // core/math3d.py _DEG
    float* coef;                     // n_rows x N_CHANNELS
    float* params;                   // N_PARAMS
};

// rot_y (core/math3d.py): (c x + s z, y + 0 c, -s x + c z)
__device__ void rot_y(float c, float s, float v[3]) {
    const float x = c * v[0] + s * v[2];
    const float y = v[1] + c * 0.0f;
    const float z = (-s) * v[0] + c * v[2];
    v[0] = x;
    v[1] = y;
    v[2] = z;
}

// rot_z: (c x - s y, s x + c y, z + 0 c)
__device__ void rot_z(float c, float s, float v[3]) {
    const float x = c * v[0] - s * v[1];
    const float y = s * v[0] + c * v[1];
    const float z = v[2] + c * 0.0f;
    v[0] = x;
    v[1] = y;
    v[2] = z;
}

// get_color_by_time (sim/state.py) of palette p: ((p0 + p1) + p2) + p3
// with pk = mats[k] * w[k]
__device__ void palette_colour(const float* mats, const float* w,
                               float out[3]) {
    for (int c = 0; c < 3; ++c) {
        const float p0 = mats[0 * 3 + c] * w[0];
        const float p1 = mats[1 * 3 + c] * w[1];
        const float p2 = mats[2 * 3 + c] * w[2];
        const float p3 = mats[3 * 3 + c] * w[3];
        out[c] = ((p0 + p1) + p2) + p3;
    }
}

// move_lights (sim/state.py): the sun and the moon, and their colour value
__device__ void lights(const Args& a, float pos[2][3], float* val) {
    float t = *a.day_time / 24.0f;
    t = t * 360.0f;
    t = t - 120.0f;
    const float ang = fmodf(t, 360.0f) * a.deg;
    float b[3] = {cosf(ang) * 500.0f, sinf(ang) * 500.0f, 0.0f * 500.0f};
    const float tilt = *a.tilt * a.deg;
    rot_y(cosf(tilt), sinf(tilt), b);
    for (int k = 0; k < 3; ++k) {
        pos[0][k] = b[k] + a.offset[k];
        pos[1][k] = (-b[k]) + a.offset[k];
    }
    *val = fabsf(pos[0][1]) / 500.0f;
}

// camera_rays (sim/state.py): the corners LD, RD, LU, RU
__device__ void corners(const Args& a, float out[4][3]) {
    const float h = tanf((*a.fov / 2.0f) * a.deg);
    const float w = h * a.aspect;
    const float az = (-*a.ver) * a.deg;
    const float ay = (-*a.hor) * a.deg;
    const float cz = cosf(az), sz = sinf(az);
    const float cy = cosf(ay), sy = sinf(ay);
    for (int i = 0; i < 4; ++i) {
        out[i][0] = 1.0f;
        out[i][1] = i < 2 ? -h : h;
        out[i][2] = i % 2 ? w : -w;
        rot_z(cz, sz, out[i]);
        rot_y(cy, sy, out[i]);
    }
}

// cluster_bounds' sphere bound (render/cuda_rt.py) over rows first.. of
// the table: centre (min + max) * 0.5, radius
// max(sqrt(|p - c|^2) + r) * 1.001 + 0.01, with the light rows' centres
// taken from pos
__device__ void sphere_bound(const Args& a, int first, int rows,
                             const float pos[2][3], float out[4]) {
    float mn[3], mx[3];
    for (int i = 0; i < rows; ++i) {
        const int row = first + i;
        for (int k = 0; k < 3; ++k) {
            const float v =
                row == a.light0 ? pos[0][k]
                : row == a.light1 ? pos[1][k]
                : a.base_coef[row * N_CHANNELS + C_CENTER + k];
            mn[k] = (i == 0 || v < mn[k]) ? v : mn[k];
            mx[k] = (i == 0 || v > mx[k]) ? v : mx[k];
        }
    }
    float c[3];
    for (int k = 0; k < 3; ++k) c[k] = (mn[k] + mx[k]) * 0.5f;
    float r = 0.0f;
    for (int i = 0; i < rows; ++i) {
        const int row = first + i;
        float q[3];
        for (int k = 0; k < 3; ++k) {
            const float v =
                row == a.light0 ? pos[0][k]
                : row == a.light1 ? pos[1][k]
                : a.base_coef[row * N_CHANNELS + C_CENTER + k];
            const float d = v - c[k];
            q[k] = d * d;
        }
        const float s = sqrtf((q[0] + q[1]) + q[2]) + a.sph_r[row];
        r = (i == 0 || s > r) ? s : r;
    }
    for (int k = 0; k < 3; ++k) out[k] = c[k];
    out[3] = r * (float)1.001 + (float)0.01;
}

__global__ void __launch_bounds__(THREADS) frame_packs_kernel(const Args a) {
    __shared__ float colour[N_PALETTES][3];
    __shared__ float light[2][3];
    __shared__ float light_val;
    __shared__ float corner[4][3];
    const int tid = threadIdx.x;

    // the frame's scalars, one warp each, while the others copy
    if (tid == 0) {
        for (int p = 0; p < N_PALETTES; ++p)
            palette_colour(a.palette[p], a.recolor, colour[p]);
    } else if (tid == 32) {
        lights(a, light, &light_val);
    } else if (tid == 64) {
        corners(a, corner);
    }
    const int n = a.n_rows * N_CHANNELS;
    for (int i = tid; i < n; i += THREADS) a.coef[i] = a.base_coef[i];
    for (int i = tid; i < N_PARAMS; i += THREADS)
        a.params[i] = a.base_params[i];
    __syncthreads();

    for (int row = tid; row < a.n_rows; row += THREADS) {
        const int cls = a.row_class[row];
        if (cls > 0)
            for (int k = 0; k < 3; ++k)
                a.coef[row * N_CHANNELS + C_COL + k] = colour[cls - 1][k];
    }
    if (tid == 0) {
        // pack_params: camera, corners, lights, light colours, ambient, sea
        float* p = a.params;
        for (int k = 0; k < 3; ++k) p[P_CAMPOS + k] = a.cam_pos[k];
        for (int i = 0; i < 4; ++i)
            for (int k = 0; k < 3; ++k) p[P_LD + 3 * i + k] = corner[i][k];
        for (int i = 0; i < 2; ++i)
            for (int k = 0; k < 3; ++k) {
                p[P_LPOS0 + 3 * i + k] = light[i][k];
                p[P_LCOL0 + 3 * i + k] = light_val;
            }
        for (int k = 0; k < 3; ++k)
            p[P_AMBIENT + k] = colour[N_PALETTES - 1][k];
        p[P_SEAY] = *a.sea_y;
    } else if (tid == 32) {
        // the light proxies' rows: centre, normal (= centre), |pos|^2
        for (int i = 0; i < 2; ++i) {
            float* row = a.coef + (i ? a.light1 : a.light0) * N_CHANNELS;
            for (int k = 0; k < 3; ++k) {
                row[C_CENTER + k] = light[i][k];
                row[C_NORMAL + k] = light[i][k];
            }
            row[C_POS2] = (light[i][0] * light[i][0]
                           + light[i][1] * light[i][1])
                          + light[i][2] * light[i][2];
        }
        // the bounds of the sphere clusters that hold a light
        for (int m = 0; m < a.n_moving; ++m) {
            const int* g = a.moving + 3 * m;
            sphere_bound(a, g[0], g[1], light,
                         a.params + P_CLUSTERS + 4 * g[2]);
        }
    }
}

}  // namespace

// Loads the kernel's module (lazy module loading defers it to the first
// launch otherwise, which must not fall inside a stream capture).
extern "C" int rt_packs_load() {
    cudaFuncAttributes attr;
    return (int)cudaFuncGetAttributes(&attr, frame_packs_kernel);
}

// One launch on `stream`: the frame's coef (n_rows x N_CHANNELS) and params
// (N_PARAMS) from the base and the state; every pointer on the device.
// palettes: the tree, mountain, lake and ambient palettes (4 x 3 each).
extern "C" int rt_frame_packs(
    const float* base_coef, const float* base_params, const int* row_class,
    const float* sph_r, const int* moving, int n_rows, int n_moving,
    int light0, int light1, const float* cam_pos, const float* hor,
    const float* ver, const float* fov, const float* day_time,
    const float* sea_y, const float* recolor, const float* tree,
    const float* mount, const float* lake, const float* ambient,
    const float* tilt, const float* offset, float aspect, float deg,
    float* coef, float* params, void* stream) {
    if (n_rows < 1 || n_moving < 0 || light0 < 0 || light0 >= n_rows
        || light1 < 0 || light1 >= n_rows)
        return (int)cudaErrorInvalidValue;
    const Args a{base_coef, base_params, row_class, sph_r, moving, n_rows,
                 n_moving, light0, light1, cam_pos, hor, ver, fov, day_time,
                 sea_y, recolor, {tree, mount, lake, ambient}, tilt, offset,
                 aspect, deg, coef, params};
    frame_packs_kernel<<<1, THREADS, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

extern "C" const char* rt_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
