"""Raytracing megakernel: host packing, CUDA wrapper and plain version
(port of raytracing_cuda_tpu/render/pallas_rt.py).

The TPU kernel (`pallas_rt._make_kernel`, launched at pallas_rt.py:1151)
renders (48, 128) pixel tiles and skips clusters per tile with interval
culls. On the GPU the kernel (csrc/raytrace.cu) traces one pixel per
thread, as the reference does (kernel.cu:228-259), and culls per ray: each
ray tests only the rows under the cluster bounds it can reach (`reach`).

Host side: the scene is packed into one (N_OBJ_PAD, N_CHANNELS) float32
coefficient table (slot 0 = sea plane, then padded triangle clusters, then
padded sphere clusters) and a (N_PARAMS,) float32 params vector — the same
channel and slot maps as the JAX package, minus the TPU's middle axis.
`cull_table` lists the rows under each cull bound of the params vector;
pipeline.host_packs builds it beside the bounds.

`raytrace_planes` (one frame) and `raytrace_planes_batch` (K frames in one
launch) dispatch on the device of their inputs: a CPU tensor runs the plain
PyTorch version (brute force over every row, which the culls leave
bit-identical), a CUDA tensor launches the kernel (or raises) and needs the
cull table host_packs returns, `cull=`. They return 7 (H, W), resp.
(K, H, W), float32 planes: hit-path RGB, miss weight, miss direction xyz.
`raytrace_planes_count` is the kernel's counting launch (chip_smoke.py and
the card tests only).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from raytracing_cuda_tpu_torch.core.math3d import dot3
from raytracing_cuda_tpu_torch.core.types import CameraRays, Lights, Scene

f32 = torch.float32

MAX_DEPTH = 4        # kernel.cu:11
BIG = 1e30           # finite stand-in for +inf
# what raytrace_planes_torch(work=...) counts: rays cast (summed over
# levels) and their tests of triangle and sphere rows; hits shaded; shadow
# rays cast and occluded, and the unoccluded ones' tests of triangle and
# blocking sphere rows
WORK_KEYS = ("rays", "tri_tests", "sph_tests", "shaded", "shadow",
             "occluded", "shadow_tri_tests", "shadow_sph_tests")
# what the kernel's counting launch counts: row tests of cast rays that the
# warps executed (once per warp, however many lanes needed the row) and
# that their lanes needed, then the same two for shadow rays
COUNT_KEYS = ("cast_warp_rows", "cast_lane_rows", "shadow_warp_rows",
              "shadow_lane_rows")

# --- coefficient-table channel map (pallas_rt.py:61-83) ---
C_COL = 0            # 0-2   color rgb
C_SHINE = 3
C_SPEC = 4           # specular exponent
C_KR = 5             # mirror coefficient
C_FLAGS = 6          # islight*2 + issph
C_UNUSED7 = 7
C_CENTER = 8         # 8-10  sphere center
C_NORMAL = 11        # 11-13 static normal (plane/tris); sphere center
C_POS2 = 14          # sphere |pos|^2
C_R2 = 15            # sphere r^2 (pad rows: -1, never accepted)
C_CDET = 16          # 16-18 tri e2×e1
C_AU = 19            # 19-21 tri v0×e2
C_BU = 22            # 22-24 tri e2
C_AV = 25            # 25-27 tri e1×v0
C_BV = 28            # 28-30 tri e1
C_N = 31             # 31-33 tri e1×e2
C_V0N = 34           # tri v0·n
C_VALID = 35         # 1 for real rows (never read)
C_BLOCKS = 36        # occludes shadow rays (non-emissive), kernel.cu:188-193
C_GIDX = 37          # reference object index (tie-break key)
N_CHANNELS = 40

# --- params vector layout (pallas_rt.py:85-104) ---
P_CAMPOS = 0         # 0-2
P_LD = 3             # 3-5 frustum corners
P_RD = 6
P_LU = 9
P_RU = 12
P_LPOS0 = 15         # 15-17 light 0 position
P_LPOS1 = 18
P_LCOL0 = 21         # 21-23
P_LCOL1 = 24
P_LINT = 27          # 27-28 intensities
P_AMBIENT = 29       # 29-31
P_SEAY = 32          # sea plane height
P_ROW0 = 33          # global row offset of a band
P_CLUSTERS = 36      # MAX_CLUSTERS x (cx, cy, cz, r) cluster bounds
MAX_CLUSTERS = 24
N_PARAMS = P_CLUSTERS + 4 * MAX_CLUSTERS

ATTR_CHANNELS = (C_COL, C_COL + 1, C_COL + 2, C_SHINE, C_SPEC, C_KR,
                 C_FLAGS, C_NORMAL, C_NORMAL + 1, C_NORMAL + 2)


def _round_up(x, m):
    return (x + m - 1) // m * m


def tri_cluster_pads(T: int, tri_clusters) -> tuple:
    """Padded row count per triangle cluster (each a multiple of 8)."""
    if not tri_clusters:
        tri_clusters = (T,)
    if sum(tri_clusters) != T:
        raise ValueError(f"tri_clusters {tri_clusters} do not sum to {T}")
    return tuple(_round_up(c, 8) for c in tri_clusters)


def sph_cluster_norm(S: int, sph_clusters):
    """((count, occludes), ...) or None → (counts, pads, occludes) tuples."""
    if not sph_clusters:
        sph_clusters = ((S, True),)
    counts = tuple(c for c, _ in sph_clusters)
    if sum(counts) != S:
        raise ValueError(f"sph_clusters {sph_clusters} do not sum to {S}")
    return (counts, tuple(_round_up(c, 8) for c in counts),
            tuple(bool(o) for _, o in sph_clusters))


def tri_sub_partition(tri_clusters, t_subs):
    """Flat sub-cluster triangle counts (t_subs[k] splits cluster k's bound
    into that many equal consecutive sub-bounds)."""
    if not t_subs:
        return tuple(tri_clusters)
    if len(t_subs) != len(tri_clusters):
        raise ValueError(f"t_subs {t_subs} must have one entry per tri "
                         f"cluster {tri_clusters}")
    out = []
    for cnt, m in zip(tri_clusters, t_subs):
        if cnt % m:
            raise ValueError(f"t_subs {m} must divide cluster count {cnt}")
        out.extend([cnt // m] * m)
    return tuple(out)


def _col(v):
    v = v.to(f32)
    return v[:, None] if v.ndim == 1 else v


def _cross_fused(a, b):
    """a × b with each component rounded once as fma(a_i, b_j, -(a_j b_i)).

    This is the form XLA's CPU backend contracts jnp.cross into; the table
    then equals the JAX package's bit for bit (plain f32 products differ by
    up to 15 ulp where the two products cancel). The f64 product is exact;
    the f64 subtraction is exact unless the exponents lie > 29 bits apart.
    """
    a64, b64 = a.double(), b.double()

    def comp(i, j):
        return (a64[:, i] * b64[:, j] - (a[:, j] * b[:, i]).double()).to(f32)

    return torch.stack([comp(1, 2), comp(2, 0), comp(0, 1)], dim=-1)


def pack_scene(scene: Scene, tri_clusters=None, sph_clusters=None):
    """Build the (N_OBJ_PAD, N_CHANNELS) float32 coefficient table.

    Slot 0 is the sea plane, then the triangle clusters, then the sphere
    clusters, each padded to a multiple of 8 rows; the total is padded to a
    multiple of 8. Pad rows carry gidx 1e9, r² = -1 (the sphere accept can
    never fire, so no phantom hits at the origin) and all-zero triangle
    coefficients (det = 0, rejected).
    """
    T, S = scene.n_triangles, scene.n_spheres
    pads = tri_cluster_pads(T, tri_clusters)
    t_pad = sum(pads)
    s_counts, s_pads, _ = sph_cluster_norm(S, sph_clusters)
    s_pad = sum(s_pads)
    n_pad = _round_up(1 + t_pad + s_pad, 8)

    def zeros(n, c):
        return torch.zeros((n, c), dtype=f32)

    v0, e1, e2 = scene.tri_v0, scene.tri_e1, scene.tri_e2
    n = _cross_fused(e1, e2)
    tg = scene.tri_gidx.long()
    ones_t = torch.ones((T, 1), dtype=f32)
    tri_rows = torch.cat([
        _col(scene.color[tg]), _col(scene.shine[tg]),
        _col(scene.specular[tg]), _col(scene.mirror[tg]),
        zeros(T, 2),                                   # flags, unused
        zeros(T, 3), _col(scene.static_normal[tg]),    # center, normal
        zeros(T, 2),                                   # pos2, r2
        _cross_fused(e2, e1), _cross_fused(v0, e2), e2,
        _cross_fused(e1, v0), e1, n,
        _col(dot3(v0, n)),
        ones_t, ones_t,                                # valid, blocks
        _col(tg.to(f32)), zeros(T, N_CHANNELS - C_GIDX - 1),
    ], dim=1)

    sg = scene.sph_gidx.long()
    pos = scene.sph_pos
    is_light = _col(scene.is_light[sg])
    ones_s = torch.ones((S, 1), dtype=f32)
    sph_rows = torch.cat([
        _col(scene.color[sg]), _col(scene.shine[sg]),
        _col(scene.specular[sg]), _col(scene.mirror[sg]),
        2.0 * is_light + 1.0, zeros(S, 1),
        pos, pos,                                      # center; normal = center
        _col(dot3(pos, pos)), _col(scene.sph_r * scene.sph_r),
        zeros(S, 19),                                  # tri coefficients
        ones_s, 1.0 - is_light,
        _col(sg.to(f32)), zeros(S, N_CHANNELS - C_GIDX - 1),
    ], dim=1)

    pl_row = torch.cat([
        _col(scene.color[0:1]), _col(scene.shine[0:1]),
        _col(scene.specular[0:1]), _col(scene.mirror[0:1]), zeros(1, 2),
        zeros(1, 3), _col(scene.plane_normal[None, :]),
        zeros(1, 21),
        torch.ones((1, 2), dtype=f32),                 # valid, blocks
        zeros(1, N_CHANNELS - C_GIDX),                 # gidx = 0
    ], dim=1)

    pad_row = zeros(1, N_CHANNELS)
    pad_row[0, C_GIDX] = 1e9
    pad_row[0, C_R2] = -1.0
    parts = [pl_row]
    off = 0
    for cnt, pad in zip(list(tri_clusters) if tri_clusters else [T], pads):
        parts += [tri_rows[off:off + cnt], pad_row.expand(pad - cnt, -1)]
        off += cnt
    off = 0
    for cnt, pad in zip(s_counts, s_pads):
        parts += [sph_rows[off:off + cnt], pad_row.expand(pad - cnt, -1)]
        off += cnt
    parts.append(pad_row.expand(n_pad - 1 - t_pad - s_pad, -1))
    return torch.cat(parts, dim=0)


def cluster_bounds(scene: Scene, tri_clusters=None, sph_clusters=None,
                   t_subs=None):
    """Bounding sphere (cx, cy, cz, r) per cull bound → (K_sub + K_sph, 4).

    AABB center of the cluster's vertices (or sphere centers), radius to the
    farthest vertex / sphere surface, * 1.001 + 0.01 float slack.
    """
    counts = (list(tri_sub_partition(tri_clusters, t_subs))
              if tri_clusters else [scene.n_triangles])
    v0 = scene.tri_v0
    v1 = v0 + scene.tri_e1
    v2 = v0 + scene.tri_e2
    out = []
    off = 0
    for cnt in counts:
        vs = torch.cat([v0[off:off + cnt], v1[off:off + cnt],
                        v2[off:off + cnt]], dim=0)
        c = (vs.amin(0) + vs.amax(0)) * 0.5
        q = (vs - c) ** 2
        r = torch.sqrt((q[:, 0] + q[:, 1] + q[:, 2]).amax()) * 1.001 + 0.01
        out.append(torch.cat([c, r[None]]))
        off += cnt
    s_counts, _, _ = sph_cluster_norm(scene.n_spheres, sph_clusters)
    off = 0
    for cnt in s_counts:
        p = scene.sph_pos[off:off + cnt]
        sr = scene.sph_r[off:off + cnt]
        c = (p.amin(0) + p.amax(0)) * 0.5
        q = (p - c) ** 2
        r = (torch.sqrt(q[:, 0] + q[:, 1] + q[:, 2]) + sr).amax() * 1.001 + 0.01
        out.append(torch.cat([c, r[None]]))
        off += cnt
    return torch.stack(out)


def cull_groups(n_triangles: int, n_spheres: int, tri_clusters=None,
                sph_clusters=None, t_subs=None) -> tuple:
    """The coefficient-table rows under each cull bound, in the order of
    the bounds in the params vector (cluster_bounds): ((first row, row
    count), ...), the triangle sub-bounds first, then the sphere
    clusters."""
    pads = tri_cluster_pads(n_triangles, tri_clusters)
    counts = tri_clusters or (n_triangles,)
    subs = t_subs or (1,) * len(pads)
    groups, row = [], 1
    for cnt, pad, m in zip(counts, pads, subs):
        groups += [(row + u * (cnt // m), cnt // m) for u in range(m)]
        row += pad
    s_counts, s_pads, _ = sph_cluster_norm(n_spheres, sph_clusters)
    for cnt, pad in zip(s_counts, s_pads):
        groups.append((row, cnt))
        row += pad
    return tuple(groups)


def cull_table(coef, groups) -> torch.Tensor:
    """The kernel's cull groups of a packed table → (G, 3) int32 on the
    host: per group of `groups` (cull_groups), its first row, its row count
    and 1 where one of its rows blocks shadow rays (coef's C_BLOCKS: every
    triangle, a sphere that is not a light). host_packs builds it beside
    the bounds, from the same cluster arguments."""
    rows = np.asarray(groups, dtype=np.int64).reshape(-1, 2)
    # blocking rows before each row: a group blocks where the count grows
    before = np.concatenate([[0], np.cumsum(coef[:, C_BLOCKS].numpy() > 0)])
    blocks = before[rows.sum(1)] > before[rows[:, 0]]
    return torch.from_numpy(np.column_stack([rows, blocks]).astype(np.int32))


def pack_params(cam_rays: CameraRays, lights: Lights, ambient, sea_y,
                row0=0):
    """The (N_PARAMS,) float32 params vector (cluster slots left zero)."""
    p = torch.zeros((N_PARAMS,), dtype=f32)
    segs = [
        (P_CAMPOS, cam_rays.pos), (P_LD, cam_rays.LD), (P_RD, cam_rays.RD),
        (P_LU, cam_rays.LU), (P_RU, cam_rays.RU),
        (P_LPOS0, lights.pos[0]), (P_LPOS1, lights.pos[1]),
        (P_LCOL0, lights.color[0]), (P_LCOL1, lights.color[1]),
        (P_LINT, lights.intensity), (P_AMBIENT, ambient),
        (P_SEAY, sea_y), (P_ROW0, row0),
    ]
    for off, v in segs:
        v = torch.as_tensor(v, dtype=f32).reshape(-1)
        p[off:off + v.numel()] = v
    return p


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

def _norm3(x, y, z):
    # guarded: zero vectors stay finite (pallas_rt.py:400-403)
    inv = 1.0 / torch.sqrt(torch.clamp(x * x + y * y + z * z, min=1e-20))
    return x * inv, y * inv, z * inv


def _dot(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def _mul_add(a, b, c):
    """a * b + c with the product rounded before the sum, as
    csrc/raytrace.cu computes it (built with -fmad=false). The frustum lerp
    and the hit points go through here: XLA's CPU code contracts these two
    into fused multiply-adds, which sends a few rays of a frame elsewhere
    where a hit turns on the last bit (tests/test_torch_properties.py swaps
    a fused version in to show it)."""
    return a * b + c


def _ch(C, c):
    """Channel c of the row table as a (1, R) row for (n, R) broadcasting."""
    return C[None, :, c]


def _tri_t(C, ox, oy, oz, dx, dy, dz, mx, my, mz):
    """Triangle t (n, R), BIG where rejected (pallas_rt._tri_t)."""
    det = _dot(dx, dy, dz, _ch(C, C_CDET), _ch(C, C_CDET + 1),
               _ch(C, C_CDET + 2))
    u_det = (_dot(dx, dy, dz, _ch(C, C_AU), _ch(C, C_AU + 1), _ch(C, C_AU + 2))
             + _dot(mx, my, mz, _ch(C, C_BU), _ch(C, C_BU + 1),
                    _ch(C, C_BU + 2)))
    v_det = (_dot(dx, dy, dz, _ch(C, C_AV), _ch(C, C_AV + 1), _ch(C, C_AV + 2))
             - _dot(mx, my, mz, _ch(C, C_BV), _ch(C, C_BV + 1),
                    _ch(C, C_BV + 2)))
    t_det = (_dot(ox, oy, oz, _ch(C, C_N), _ch(C, C_N + 1), _ch(C, C_N + 2))
             - _ch(C, C_V0N))
    acc = torch.minimum(torch.minimum(det - 0.001, t_det),
                        torch.minimum(torch.minimum(u_det, v_det),
                                      det - u_det - v_det))
    hit = acc >= 0
    t = t_det / torch.where(hit, det, torch.ones_like(det))
    return torch.where(hit, t, torch.full_like(t, BIG))


def _sph_t(C, ox, oy, oz, dx, dy, dz):
    """Sphere t (n, R), BIG where rejected (pallas_rt._sph_t)."""
    px, py, pz = _ch(C, C_CENTER), _ch(C, C_CENTER + 1), _ch(C, C_CENTER + 2)
    od = _dot(ox, oy, oz, dx, dy, dz)
    oo = _dot(ox, oy, oz, ox, oy, oz)
    tca = _dot(dx, dy, dz, px, py, pz) - od
    ll = _ch(C, C_POS2) - 2.0 * _dot(ox, oy, oz, px, py, pz) + oo
    d2 = ll - tca * tca
    r2 = _ch(C, C_R2)
    acc = torch.minimum(tca, torch.minimum(r2 - d2, d2 + 0.01))
    t = tca - torch.sqrt(torch.clamp(r2 - d2, min=0.0))
    return torch.where(acc > 0, t, torch.full_like(t, BIG))


def _plane_t(oy, dy, sea_y):
    """Sea-plane t, BIG where missed (kernel.cu:71-94)."""
    t = (sea_y - oy) / dy
    hit = (dy * dy > 0.00001) & (t >= 0)
    return torch.where(hit, t, torch.full_like(t, BIG))


def _occluded(Ct, Cs, blocks, ox, oy, oz, dx, dy, dz, sdist, sea_y):
    """Any triangle, blocking sphere or the plane closer than sdist → bool."""
    mx = oy * dz - oz * dy
    my = oz * dx - ox * dz
    mz = ox * dy - oy * dx
    col = lambda v: v[:, None]
    occ = _plane_t(oy, dy, sea_y) < sdist
    if Ct.shape[0]:
        t = _tri_t(Ct, *map(col, (ox, oy, oz, dx, dy, dz, mx, my, mz)))
        occ = occ | (t.amin(1) < sdist)
    if Cs.shape[0]:
        t = _sph_t(Cs, *map(col, (ox, oy, oz, dx, dy, dz)))
        t = torch.where(blocks[None, :], t, torch.full_like(t, BIG))
        occ = occ | (t.amin(1) < sdist)
    return occ


def reach(bounds, ox, oy, oz, dx, dy, dz, t_hi):
    """(n, G) bool: whether each of n rays (unit directions) can meet each
    of G bounding spheres (cx, cy, cz, r) before distance t_hi: its origin
    lies inside, or the sphere lies ahead within r of the ray and no
    farther than t_hi. The TPU kernel's sound cluster cull
    (pallas_rt.py:476-516) for a box of one ray."""
    col = lambda v: v[:, None]
    lx, ly, lz = (bounds[None, :, k] - col(o)
                  for k, o in enumerate((ox, oy, oz)))
    ll = lx * lx + ly * ly + lz * lz
    tca = lx * col(dx) + ly * col(dy) + lz * col(dz)
    r = bounds[None, :, 3]
    r2 = r * r
    return (ll <= r2) | ((tca > 0) & (ll - tca * tca <= r2)
                         & (tca - r <= col(t_hi)))


class _Work:
    """Counts what a chunk's rays need into a WORK_KEYS dict: a ray tests
    only the rows under the cull bounds (cull_groups) it can reach (reach),
    up to the sea plane's hit for a cast ray, up to the light for a shadow
    ray. The bound tests themselves are not counted: a tile of rays can
    share them, as the TPU kernel's do."""

    def __init__(self, counts, coef, P, n_tri, groups):
        groups = [(int(g[0]), int(g[1])) for g in groups]   # or cull_table
        self.counts = counts
        real = coef[:, C_GIDX] < 1e9
        blocks = real & (coef[:, C_BLOCKS] > 0)
        self.bounds = P[P_CLUSTERS:P_CLUSTERS + 4 * len(groups)].reshape(-1, 4)
        is_tri = torch.tensor([f < 1 + n_tri for f, _ in groups],
                              device=coef.device)
        rows = torch.stack([real[f:f + c].sum() for f, c in groups])
        block_rows = torch.stack([blocks[f:f + c].sum() for f, c in groups])
        self.tri_rows = torch.where(is_tri, rows, 0)
        self.sph_rows = torch.where(is_tri, 0, rows)
        self.sph_block_rows = torch.where(is_tri, 0, block_rows)

    def add(self, key, n):
        self.counts[key] += int(n)

    def cast(self, o, d, t_plane):
        r = reach(self.bounds, *o, *d, t_plane).long()
        self.add("rays", o[0].numel())
        self.add("tri_tests", (r * self.tri_rows).sum())
        self.add("sph_tests", (r * self.sph_rows).sum())

    def shadow(self, o, d, dist, occ):
        self.add("shadow", occ.numel())
        self.add("occluded", occ.sum())
        clear = ~occ
        o, d = [v[clear] for v in o], [v[clear] for v in d]
        r = reach(self.bounds, *o, *d, dist[clear]).long()
        self.add("shadow_tri_tests", (r * self.tri_rows).sum())
        self.add("shadow_sph_tests", (r * self.sph_block_rows).sum())


def _trace_chunk(coef, P, n_tri, n_sph, dx, dy, dz, out, sl, work=None,
                 cull=None):
    """Trace primary rays (dx, dy, dz) of one pixel chunk into out[:, sl].
    work, where given, counts what the chunk's rays needed under the cull
    groups `cull` (_Work)."""
    if work is not None:
        work = _Work(work, coef, P, n_tri, cull)
    n = dx.shape[0]
    dev = dx.device
    Ct = coef[1:1 + n_tri]
    Cs = coef[1 + n_tri:1 + n_tri + n_sph]
    blocks = Cs[:, C_BLOCKS] > 0
    gidx = torch.cat([torch.zeros(1, dtype=f32, device=dev),
                      Ct[:, C_GIDX], Cs[:, C_GIDX]])
    attr_rows = coef[:1 + n_tri + n_sph][:, list(ATTR_CHANNELS)]
    sea_y = P[P_SEAY]
    ox = P[P_CAMPOS].expand(n).clone()
    oy = P[P_CAMPOS + 1].expand(n).clone()
    oz = P[P_CAMPOS + 2].expand(n).clone()
    thr = torch.ones(n, dtype=f32, device=dev)
    acc = torch.zeros((3, n), dtype=f32, device=dev)
    mw = torch.zeros(n, dtype=f32, device=dev)
    mdir = torch.stack([dx, dy, dz])
    live = torch.arange(n, device=dev)
    col = lambda v: v[:, None]

    for _ in range(MAX_DEPTH + 1):
        if live.numel() == 0:
            break
        lox, loy, loz = ox[live], oy[live], oz[live]
        ldx, ldy, ldz = dx[live], dy[live], dz[live]
        lthr = thr[live]
        mx = loy * ldz - loz * ldy
        my = loz * ldx - lox * ldz
        mz = lox * ldy - loy * ldx

        # nearest hit: lexicographic (t, gidx) minimum over plane + rows
        t_plane = _plane_t(loy, ldy, sea_y)
        if work is not None:
            work.cast((lox, loy, loz), (ldx, ldy, ldz), t_plane)
        cands = [col(t_plane)]
        if n_tri:
            cands.append(_tri_t(Ct, *map(col, (lox, loy, loz, ldx, ldy, ldz,
                                               mx, my, mz))))
        if n_sph:
            cands.append(_sph_t(Cs, *map(col, (lox, loy, loz, ldx, ldy, ldz))))
        t_all = torch.cat(cands, dim=1)
        t_min = t_all.amin(1)
        g = torch.where(t_all == t_min[:, None], gidx[None, :],
                        torch.full_like(t_all, 2e9))
        attrs = attr_rows[g.argmin(1)]
        hit = t_min < BIG * 0.5

        # misses record (throughput, direction) for the deferred sky
        miss = live[~hit]
        mw[miss] = thr[miss]
        mdir[:, miss] = torch.stack([dx[miss], dy[miss], dz[miss]])

        sel = hit.nonzero().squeeze(1)
        live = live[sel]
        t = t_min[sel]
        lox, loy, loz, ldx, ldy, ldz, lthr = (
            v[sel] for v in (lox, loy, loz, ldx, ldy, ldz, lthr))
        (colr, colg, colb, shine, spec_e, kr, flags,
         nvx, nvy, nvz) = attrs[sel].unbind(1)
        hx, hy, hz = (_mul_add(ldx, t, lox), _mul_add(ldy, t, loy),
                      _mul_add(ldz, t, loz))
        em = flags >= 2.0
        is_sph = (flags - 2.0 * em.to(f32)) > 0
        snx, sny, snz = _norm3(hx - nvx, hy - nvy, hz - nvz)
        nx = torch.where(is_sph, snx, nvx)
        ny = torch.where(is_sph, sny, nvy)
        nz = torch.where(is_sph, snz, nvz)

        # emissive hits add their color and end the ray
        lit = live[em]
        acc[:, lit] += lthr[em] * torch.stack([colr[em], colg[em], colb[em]])

        sh = (~em).nonzero().squeeze(1)
        live = live[sh]
        if work is not None:
            work.add("shaded", sh.numel())
        (ox_, oy_, oz_, dx_, dy_, dz_, thr_, hx, hy, hz, nx, ny, nz, colr,
         colg, colb, shine, spec_e, kr) = (
            v[sh] for v in (lox, loy, loz, ldx, ldy, ldz, lthr, hx, hy, hz,
                            nx, ny, nz, colr, colg, colb, shine, spec_e, kr))

        phr = colr * P[P_AMBIENT]
        phg = colg * P[P_AMBIENT + 1]
        phb = colb * P[P_AMBIENT + 2]
        for li, (pb, cb) in enumerate(((P_LPOS0, P_LCOL0),
                                       (P_LPOS1, P_LCOL1))):
            lvx, lvy, lvz = P[pb] - hx, P[pb + 1] - hy, P[pb + 2] - hz
            sdist = torch.sqrt(lvx * lvx + lvy * lvy + lvz * lvz)
            inv = 1.0 / sdist
            sdx, sdy, sdz = lvx * inv, lvy * inv, lvz * inv
            angle = torch.clamp(nx * sdx + ny * sdy + nz * sdz, min=0.0)
            need = (angle > 0).nonzero().squeeze(1)
            if need.numel():
                q = lambda v: v[need]
                so = (q(hx) + q(sdx) * 0.001, q(hy) + q(sdy) * 0.001,
                      q(hz) + q(sdz) * 0.001)
                sd = (q(sdx), q(sdy), q(sdz))
                occ = _occluded(Ct, Cs, blocks, *so, *sd, q(sdist), sea_y)
                angle = angle.index_put((need[occ],),
                                        torch.zeros((), dtype=f32, device=dev))
                if work is not None:
                    work.shadow(so, sd, q(sdist), occ)
            aint = angle * P[P_LINT + li]
            phr = phr + colr * P[cb] * aint
            phg = phg + colg * P[cb + 1] * aint
            phb = phb + colb * P[cb + 2] * aint
            # Phong specular (kernel.cu:198-205): reflect -sdir
            ldn = -(sdx * nx + sdy * ny + sdz * nz)
            spx, spy, spz = _norm3(-sdx - 2.0 * ldn * nx, -sdy - 2.0 * ldn * ny,
                                   -sdz - 2.0 * ldn * nz)
            sbase = torch.clamp(-(spx * dx_ + spy * dy_ + spz * dz_), min=0.0)
            # pow(s, e) as exp2(e·log2 s); pow(0, e) is 0 for e > 0, 1 at e = 0
            spec_pow = torch.where(
                sbase > 0,
                torch.exp2(spec_e * torch.log2(torch.clamp(sbase, min=1e-30))),
                torch.where(spec_e > 0, 0.0, 1.0))
            spec = torch.where(shine > 0, spec_pow * shine * angle, 0.0)
            phr = phr + spec
            phg = phg + spec
            phb = phb + spec

        w = thr_ * (1.0 - kr)
        acc[:, live] += torch.stack([w * phr, w * phg, w * phb])

        # mirror bounce (kernel.cu:209-218); every other ray dies
        ddn = dx_ * nx + dy_ * ny + dz_ * nz
        rx, ry, rz = _norm3(dx_ - 2.0 * ddn * nx, dy_ - 2.0 * ddn * ny,
                            dz_ - 2.0 * ddn * nz)
        b = (kr > 0).nonzero().squeeze(1)
        live = live[b]
        ox[live] = hx[b] + rx[b] * 0.001
        oy[live] = hy[b] + ry[b] * 0.001
        oz[live] = hz[b] + rz[b] * 0.001
        dx[live], dy[live], dz[live] = rx[b], ry[b], rz[b]
        thr[live] = thr_[b] * kr[b]

    out[0:3, sl] = acc
    out[3, sl] = mw
    out[4:7, sl] = mdir


def check_frame(H: int, W: int, row0: int, total_h: int) -> None:
    """Refuse a band the pixel-to-ray map is not defined for. A pixel's
    frustum coordinates are col / (W - 1) and row / (total_h - 1)
    (kernel.cu:244-253), so a frame one pixel wide or one row high has
    none: the JAX package divides by zero there (pallas_rt.py:643-644
    raises ZeroDivisionError). On every device."""
    if W < 2 or total_h < 2:
        raise ValueError(f"a frame needs at least 2 x 2 pixels to place its "
                         f"rays, got {W} wide and {total_h} high")
    if H < 1 or row0 < 0:
        raise ValueError(f"a band needs at least one row at row0 >= 0, got "
                         f"{H} rows at row0 {row0}")


def primary_rays(params, H: int, W: int, row0: int = 0, total_h=None):
    """Frustum-corner lerp (kernel.cu:244-253) → unit directions, 3 x (H*W)."""
    total_h = H if total_h is None else total_h
    check_frame(H, W, row0, total_h)
    dev = params.device
    P = params
    px = (torch.arange(W, device=dev, dtype=f32)
          * float(np.float32(1.0 / (W - 1))))[None, :]
    py = ((torch.arange(H, device=dev, dtype=f32) + float(row0))
          * float(np.float32(1.0 / (total_h - 1))))[:, None]
    dirs = []
    for k in range(3):
        vd = _mul_add(P[P_RD + k] - P[P_LD + k], px, P[P_LD + k])
        vu = _mul_add(P[P_RU + k] - P[P_LU + k], px, P[P_LU + k])
        dirs.append(_mul_add(-(vu - vd), py, vu))
    return tuple(v.reshape(-1) for v in _norm3(*dirs))


def raytrace_planes_torch(coef, params, H: int, W: int, n_tri_rows: int,
                          n_sph_rows: int, row0: int = 0, total_h=None,
                          chunk: int = 65536, work: dict | None = None,
                          cull=None):
    """Plain PyTorch megakernel: 7 (H, W) float32 planes, chunked over pixels.

    The same math as csrc/raytrace.cu (and the TPU kernel minus its output-
    identical culls): per chunk of pixels, up to MAX_DEPTH + 1 levels over
    the plane and all rows, with the rays still alive compacted each level.
    A `work` dict (WORK_KEYS, each starting at 0) counts what this input
    needs: rays cast (summed over levels), non-emissive hits shaded, shadow
    rays cast and occluded, and the row tests of the cast and unoccluded
    shadow rays, each ray counting only the rows under the cull bounds it
    can reach; it needs `cull`, the cull_groups (or cull_table) of the
    packed scene. Without `work`, `cull` is not read.
    """
    if work is not None and (cull is None or len(cull) == 0):
        raise ValueError("counting work needs the scene's cull groups")
    dx, dy, dz = primary_rays(params, H, W, row0, total_h)
    out = torch.empty((7, H * W), dtype=f32, device=coef.device)
    for s in range(0, H * W, chunk):
        sl = slice(s, min(s + chunk, H * W))
        _trace_chunk(coef, params, n_tri_rows, n_sph_rows, dx[sl].clone(),
                     dy[sl].clone(), dz[sl].clone(), out, sl, work, cull)
    return tuple(out.reshape(7, H, W))


def raytrace_planes_batch_torch(coefs, params, H: int, W: int,
                                n_tri_rows: int, n_sph_rows: int,
                                row0: int = 0, total_h=None,
                                work: dict | None = None, cull=None):
    """Plain K-frame megakernel: 7 (K, H, W) float32 planes, one
    raytrace_planes_torch call per frame."""
    per_frame = [raytrace_planes_torch(c, p, H, W, n_tri_rows, n_sph_rows,
                                       row0, total_h, work=work, cull=cull)
                 for c, p in zip(coefs, params)]
    return tuple(torch.stack(planes) for planes in zip(*per_frame))


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------

def _check_cull(cull, device):
    """The CUDA path's cull table: required, (G, 3) int32 on `device`."""
    if cull is None:
        raise ValueError("the raytrace kernel needs the scene's cull table "
                         "(cull=, the one host_packs returns); it tests only "
                         "the rows of the groups it is given")
    if (not isinstance(cull, torch.Tensor) or cull.dtype != torch.int32
            or cull.ndim != 2 or cull.shape[1] != 3
            or not 1 <= cull.shape[0] <= MAX_CLUSTERS
            or not cull.is_contiguous() or cull.device != device):
        raise ValueError(f"cull must be a contiguous (G, 3) int32 tensor on "
                         f"{device} with 1 <= G <= {MAX_CLUSTERS}, got "
                         f"{getattr(cull, 'dtype', type(cull))} "
                         f"{tuple(getattr(cull, 'shape', ()))}")


def _launch(coefs, params, H, W, n_tri_rows, n_sph_rows, row0, total_h, cull,
            counts=None):
    """One launch of csrc/raytrace.cu over K frames → (7, K, H, W) float32.
    With `counts` (4 zeroed int64 on the device), the counting launch adds
    its COUNT_KEYS tallies there."""
    from raytracing_cuda_tpu_torch import _build

    check_frame(H, W, row0, total_h)
    for name, t in (("coefs", coefs), ("params", params)):
        if t.dtype != f32 or not t.is_contiguous() or t.device != coefs.device:
            raise ValueError(f"{name} must be a contiguous float32 tensor on "
                             f"{coefs.device}")
    _check_cull(cull, coefs.device)
    n_rows = 1 + n_tri_rows + n_sph_rows
    K = coefs.shape[0] if coefs.ndim == 3 else 0
    if (coefs.ndim != 3 or coefs.shape[2] != N_CHANNELS
            or coefs.shape[1] < n_rows or params.shape != (K, N_PARAMS)):
        raise ValueError(f"bad shapes coefs {tuple(coefs.shape)} params "
                         f"{tuple(params.shape)} for {n_rows} rows")
    if not 1 <= K <= 65535:
        raise ValueError(f"K = {K} frames; the kernel takes 1 to 65535")
    lib = _build.load("raytrace")
    fn = lib.rt_raytrace_planes if counts is None else lib.rt_raytrace_count
    args = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    fn.argtypes = args + ([] if counts is None else [ctypes.c_void_p]) + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty((7, K, H, W), dtype=f32, device=coefs.device)
    # the frames' tile counters, zeroed by the launcher on the stream
    tile_next = torch.empty(K, dtype=torch.int32, device=coefs.device)
    tail = [tile_next.data_ptr()] + ([] if counts is None
                                     else [counts.data_ptr()])
    with torch.cuda.device(coefs.device):
        stream = torch.cuda.current_stream(coefs.device).cuda_stream
        err = fn(coefs.data_ptr(), coefs.shape[1], n_rows, 1 + n_tri_rows,
                 n_rows, params.data_ptr(), cull.data_ptr(), cull.shape[0],
                 out.data_ptr(), K, H, W, row0,
                 float(np.float32(1.0 / (W - 1))),
                 float(np.float32(1.0 / (total_h - 1))), *tail, stream)
    _build.check(lib, err, "raytrace kernel launch")
    return out


def _on_cuda(t):
    if t.device.type != "cuda":
        raise ValueError(f"no raytrace kernel for device {t.device}")


def raytrace_planes_batch(coefs, params, H: int, W: int, n_tri_rows: int,
                          n_sph_rows: int, row0: int = 0, total_h=None,
                          cull=None):
    """K-frame megakernel → 7 (K, H, W) float32 planes.

    coefs (K, n_rows, N_CHANNELS) and params (K, N_PARAMS), one scene table
    and params vector per frame, all with the same row layout. CPU tensors
    run raytrace_planes_batch_torch (cull is not read); CUDA tensors launch
    csrc/raytrace.cu once with the frame in the grid (replaces
    pallas_rt.py:1151 with grid (K, H/TH, W/TW)), culling by `cull`, the
    cull table host_packs returns, on the same device, and count one launch
    and K frames.
    """
    total_h = H if total_h is None else total_h
    if coefs.device.type == "cpu":
        return raytrace_planes_batch_torch(coefs, params, H, W, n_tri_rows,
                                           n_sph_rows, row0, total_h)
    _on_cuda(coefs)
    out = _launch(coefs, params, H, W, n_tri_rows, n_sph_rows, row0, total_h,
                  cull)
    raytrace_planes_batch.launches += 1
    raytrace_planes_batch.frames += coefs.shape[0]
    return tuple(out)


raytrace_planes_batch.launches = 0
raytrace_planes_batch.frames = 0


def raytrace_planes(coef, params, H: int, W: int, n_tri_rows: int,
                    n_sph_rows: int, row0: int = 0, total_h=None, cull=None):
    """Megakernel → 7 (H, W) float32 planes (r, g, b, miss weight, miss dir).

    The K = 1 call of the batch kernel (as pallas_rt.py:1174-1189). CPU
    tensors run raytrace_planes_torch (cull is not read); CUDA tensors
    launch csrc/raytrace.cu with `cull`, the cull table host_packs returns,
    on the same device, and count the launch on this wrapper. row0/total_h place an
    H-row band inside a total_h-row frame.
    """
    total_h = H if total_h is None else total_h
    if coef.device.type == "cpu":
        return raytrace_planes_torch(coef, params, H, W, n_tri_rows,
                                     n_sph_rows, row0, total_h)
    _on_cuda(coef)
    out = _launch(coef[None], params[None], H, W, n_tri_rows, n_sph_rows,
                  row0, total_h, cull)
    raytrace_planes.launches += 1
    return tuple(out[:, 0])


raytrace_planes.launches = 0


def raytrace_planes_count(coefs, params, H: int, W: int, n_tri_rows: int,
                          n_sph_rows: int, row0: int = 0, total_h=None,
                          cull=None):
    """The kernel's counting launch over K frames (CUDA only) → (7 (K, H, W)
    planes, {COUNT_KEYS: int}). The same body as raytrace_planes_batch,
    which also counts, per warp, the row tests the warp executed and the
    row tests its lanes needed; their ratio is the culls' lane efficiency.
    Not a launch of the main path, and not counted as one."""
    _on_cuda(coefs)
    total_h = H if total_h is None else total_h
    counts = torch.zeros(len(COUNT_KEYS), dtype=torch.int64,
                         device=coefs.device)
    out = _launch(coefs, params, H, W, n_tri_rows, n_sph_rows, row0, total_h,
                  cull, counts)
    return tuple(out), dict(zip(COUNT_KEYS, counts.tolist()))
