"""Port tests: the whole-table forward kernel K1 (``csrc/render_fwd.cu``)
since it scans the shadow rows in the TPU kernel's order (rows outer,
samples inner, a row's invariants hoisted) with one thread per AA ray.

On the CPU: the launch geometry that ``kernels/render_fwd.py`` states for
the kernel (``pixels_per_block``, ``shared_bytes``: every AA ray of a frame
taken exactly once, coalesced record writes, the colours inside their
region) for any AA count and ragged widths; the routing unchanged;
``flops.fwd_work``'s hoisted count against its formula and against the
per-sample count on the plain record of the five baseline configs; and a
float32 transcription of the kernel's two scan orders (per sample with an
early exit, the JAX package's ``_lit_count`` order with a bit mask in
chunks) giving the same decisions on seeded rows and samples, quads,
``dA == 0`` and glass rows included. Decisions are compared exactly: both orders run
the same float32 operations.

Tests marked ``cuda`` launch K1 and the streamed kernel K3f and hold them
bit for bit (image, packed image, pid, lit, bid) at 64x64 or smaller; they
skip without a card."""
import dataclasses
import math

import numpy as np
import pytest
import torch

import uob_raytracer_tpu_torch as trt
from uob_raytracer_tpu_torch import ShadingModel, flops
from uob_raytracer_tpu_torch.kernels import render_fwd as tfwd
from uob_raytracer_tpu_torch.ops.image import pack_argb
from uob_raytracer_tpu_torch.ops.quads import detect_shadow_quads
from conftest import assert_images_match

F = np.float32
THREADS, WARP, CHUNK = tfwd.THREADS, 32, 8


# --------------------------------------------------------------------------
# The launch geometry
# --------------------------------------------------------------------------

def kernel_items(n_pix: int, A: int):
    """The kernel's thread -> ray map, transcribed from render_fwd_kernel:
    block b takes pixels [b * ppb, (b + 1) * ppb); thread t of the block
    takes items t, t + THREADS, ... < ppb * A, item i being ray a = i // ppb
    of the block's pixel l = i % ppb. Yields (block, round, thread, a, p)
    for the items inside the frame."""
    ppb = tfwd.pixels_per_block(A)
    for blk in range(-(-n_pix // ppb)):
        for rnd in range(-(-ppb * A // THREADS)):
            for t in range(THREADS):
                item = t + rnd * THREADS
                a, lp = divmod(item, ppb)
                p = blk * ppb + lp
                if item < ppb * A and p < n_pix:
                    yield blk, rnd, t, a, lp, p


@pytest.mark.parametrize("A", [1, 2, 3, 4, 9, 16])
@pytest.mark.parametrize("width,rows", [(37, 5), (64, 3), (100, 2)])
def test_launch_takes_every_ray_once(A, width, rows):
    """Every AA ray of a ragged frame (or row band) is one thread's item
    exactly once; the block's colours fit the region shared_bytes adds;
    each round fills whole warps, and a warp takes one AA index of
    consecutive pixels (the A-major record is written coalesced)."""
    ppb = tfwd.pixels_per_block(A)
    assert ppb % WARP == 0 and (ppb * A) % THREADS == 0
    assert ppb == 32 * 4 // math.gcd(A, 4)
    n_pix = width * rows
    seen = np.zeros((A, n_pix), np.int64)
    warps = {}
    for blk, rnd, t, a, lp, p in kernel_items(n_pix, A):
        seen[a, p] += 1
        assert 0 <= (a * 3 + 2) * ppb + lp < ppb * A * 3   # col[a][c][lp]
        warps.setdefault((blk, rnd, t // WARP), []).append((a, p))
    assert (seen == 1).all()
    for lanes in warps.values():
        assert len({a for a, _ in lanes}) == 1
        ps = [p for _, p in lanes]
        assert ps == list(range(ps[0], ps[0] + len(ps)))
    # launch_smem's layout, transcribed: the triangle table and the primary
    # invariants, the sphere, camera and shadow tables, the colours
    for n_tri, n_sph, n_shd in ((26, 2, 15), (26, 0, 0), (320, 4, 320)):
        regions = [19 * n_tri, 7 * n_tri, 12 * n_sph, 21, 13 * n_shd,
                   ppb * A * 3]
        assert tfwd.shared_bytes(n_tri, n_sph, n_shd, A) == 4 * sum(regions)


def _old_use_streamed(n_tri: int, n_sph: int) -> bool:
    """use_streamed as it stood before the kernel took one thread per AA
    ray (its forward tables without the rays' colours)."""
    fwd = 4 * (n_tri * (19 + 7) + n_sph * 12 + 21 + n_tri * 13)
    return (n_tri > 320 or fwd > tfwd.SMEM_BUDGET_BYTES
            or tfwd.bwd_shared_bytes(n_tri + n_sph) > tfwd.SMEM_BUDGET_BYTES)


def test_routing_unchanged():
    got = [[tfwd.use_streamed(t, s) for s in range(5)] for t in range(1, 2049)]
    want = [[_old_use_streamed(t, s) for s in range(5)] for t in range(1, 2049)]
    assert got == want
    # the crossover's largest whole-table scene still fits, at 16 AA rays
    assert tfwd.shared_bytes(1024, 2, 1024, 16) <= tfwd.SMEM_BUDGET_BYTES


# --------------------------------------------------------------------------
# The operation count
# --------------------------------------------------------------------------

def _frame(name: str, size: int = 32):
    cfg = dataclasses.replace(trt.baseline_configs()[name], width=size,
                              height=size)
    scene = trt.cornell_box(
        device="cpu", spheres=not cfg.cpu_ref,
        shading=cfg.shading if cfg.cpu_ref else ShadingModel.DEVICE)
    quads = None if cfg.cpu_ref else detect_shadow_quads(scene)
    return cfg, scene, quads


@pytest.mark.parametrize("name", sorted(trt.baseline_configs()))
def test_fwd_work_hoisted_count(name):
    """fwd_work counts the row and sphere invariants once per shading ray
    and the sample part per row and live sample: its formula, below the
    per-sample count wherever a ray has more than one sample, equal to it
    at one."""
    cfg, scene, quads = _frame(name)
    _, _, res = tfwd.render_fused_res_plain(scene, cfg)

    nb, ops = flops.fwd_work(cfg, scene, quads, res, False)
    nb_old, ops_old = flops.fwd_work(cfg, scene, quads, res, False,
                                     per_sample=True)
    n_rows = scene.num_triangles if quads is None else sum(map(len, quads))
    n_sph = 0 if cfg.cpu_ref else scene.num_spheres
    lit_cnt = res.lit_cnt.double()
    shading = int((lit_cnt > 0).sum())
    lit = float(lit_cnt.sum())
    occ = shading * cfg.shadow_samples - lit
    rays = res.prim_id.numel()
    steps = int((res.bounce_id >= 0).sum())
    base = (rays * (30 + 26 * scene.num_triangles + 40 * n_sph)
            + steps * (90 + 70 * scene.num_triangles + 45 * n_sph)
            + shading * 60 + (lit + occ) * 30)
    assert ops == base + shading * (27 * n_rows + 9 * n_sph) \
        + lit * (28 * n_rows + 21 * n_sph) + occ * 28
    assert ops_old == base + lit * (55 * n_rows + 30 * n_sph) + occ * 55
    assert nb == nb_old and shading > 0
    if cfg.shadow_samples > 1:
        assert ops < ops_old
    else:
        assert ops == ops_old


# --------------------------------------------------------------------------
# The two scan orders, transcribed in float32
# --------------------------------------------------------------------------

def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _invariants(row, start):
    """occ_row_invariants: E, b x e2, e1 x b, t_num, t_num^2 of rows [R,13]
    (v0 e1 e2 E mat, the shadow table's layout)."""
    v0, e1, e2, E = row[..., 0:3], row[..., 3:6], row[..., 6:9], row[..., 9:12]
    b = start - v0
    t_num = _dot(b, E)
    return E, _cross(b, e2), _cross(e1, b), t_num, t_num * t_num


def _sample(inv, quad, d, dds, r2):
    """occ_row_sample for rows inv [R] and sample rays d [..., 3]."""
    E, B2, B1, t_num, t_num2 = inv
    dA = -_dot(d, E)
    u_n = -_dot(d, B2)
    v_n = -_dot(d, B1)
    dA2 = dA * dA
    base = ((t_num * dA >= 0) & (t_num2 * dds < r2 * dA2)
            & (u_n * dA >= 0) & (v_n * dA >= 0))
    inb = torch.where(quad, (u_n * dA <= dA2) & (v_n * dA <= dA2),
                      ((u_n + v_n) * dA <= dA2) & (dA != 0))
    return base & inb


def _sph_hit(c, r2s, start, d, dds, r2):
    """occ_sph_sample after occ_sph_invariants (L, c_q), the stable
    quadratic with the q == 0 and a == 0 guards."""
    L = start - c
    c_q = _dot(L, L) - r2s
    b_q = 2.0 * _dot(d, L)
    disc = b_q * b_q - 4.0 * dds * c_q
    no_sol = disc < 0
    sq = torch.sqrt(torch.where(no_sol, 1.0, disc))
    q = torch.where(b_q > 0, -0.5 * (b_q + sq), -0.5 * (b_q - sq))
    x0 = q / torch.where(dds == 0, 1.0, dds)
    x1 = torch.where(q == 0, x0, c_q / q)
    xmin, xmax = torch.minimum(x0, x1), torch.maximum(x0, x1)
    return ~no_sol & (((xmin >= 0) & (xmin * xmin * dds < r2))
                      | ((xmax >= 0) & (xmax * xmax * dds < r2)))


def per_sample_order(rows, n_quads, sph, start, dirs, r2):
    """The kernel before the hoist (occluded()): each sample scans the rows
    in order, each row's invariants recomputed, to its first occluder, then
    the spheres. Returns the occluded bits [S]."""
    out = []
    for d in dirs:
        dds = _dot(d, d)
        hit = False
        for r in range(rows.shape[0]):
            if rows[r, 12] == -1.0:          # glass casts no shadow
                continue
            if bool(_sample(_invariants(rows[r], start),
                            torch.tensor(r < n_quads), d, dds, r2)):
                hit = True
                break
        for c, r2s, mat in sph:
            if hit:
                break
            if mat != -1.0 and bool(_sph_hit(c, r2s, start, d, dds, r2)):
                hit = True
        out.append(hit)
    return torch.tensor(out)


def hoisted_order(rows, n_quads, sph, start, dirs, r2):
    """The kernel's scan (occluded_samples): per chunk of CHUNK samples a
    mask of the live ones; rows outer, each row's invariants once, the
    sample part for the live samples; the scan ends when the mask is
    empty; then the spheres, L and c_q once each, for the samples still
    live. Returns the occluded bits [S]."""
    S = dirs.shape[0]
    occluded = torch.zeros(S, dtype=torch.bool)
    for s0 in range(0, S, CHUNK):
        d = dirs[s0:s0 + CHUNK]
        dds = _dot(d, d)
        live = torch.ones(d.shape[0], dtype=torch.bool)
        for r in range(rows.shape[0]):
            if not live.any():
                break
            if rows[r, 12] == -1.0:
                continue
            inv = _invariants(rows[r], start)
            live &= ~_sample(inv, torch.tensor(r < n_quads), d, dds, r2)
        for c, r2s, mat in sph:
            if live.any() and mat != -1.0:
                live &= ~_sph_hit(c, r2s, start, d, dds, r2)
        occluded[s0:s0 + CHUNK] = ~live
    return occluded


def _random_case(seed: int, n_rows: int, n_quads: int, S: int):
    """Rows spanning the segment from the shading point at the origin to a
    light at (0, 0, 2), some glass, some axis-aligned so that an
    axis-aligned sample meets them with dA == 0 exactly; samples jittered
    about the light, the first two exactly along z."""
    rs = np.random.RandomState(seed)
    v0 = rs.uniform(-0.6, 0.6, (n_rows, 3)).astype(F)
    v0[:, 2] = rs.uniform(0.1, 2.4, n_rows).astype(F)
    e1 = rs.uniform(-1.0, 1.0, (n_rows, 3)).astype(F)
    e2 = rs.uniform(-1.0, 1.0, (n_rows, 3)).astype(F)
    flat = rs.rand(n_rows) < 0.25              # E = (0, 1, 0): dA == 0 on z
    e1[flat], e2[flat] = F([0.0, 0.0, 1.0]), F([1.0, 0.0, 0.0])
    rows = torch.from_numpy(np.concatenate([v0, e1, e2], 1))
    E = _cross(rows[:, 3:6], rows[:, 6:9])
    mat = torch.from_numpy(np.where(rs.rand(n_rows) < 0.2, F(-1.0), F(1.0)))
    rows = torch.cat([rows, E, mat[:, None]], 1)
    sdir = torch.tensor([0.0, 0.0, 2.0])
    jit = torch.from_numpy(rs.uniform(-0.4, 0.4, (S, 3)).astype(F))
    jit[:2] = 0.0
    dirs = sdir + jit
    sph = [(torch.from_numpy(rs.uniform(-0.3, 0.3, 3).astype(F)) + torch.tensor([0.0, 0.0, 1.0]),
            torch.tensor(F(rs.uniform(0.01, 0.05))), m) for m in (1.0, -1.0)]
    start = torch.zeros(3)
    return rows, n_quads, sph, start, dirs, _dot(sdir, sdir)


@pytest.mark.parametrize("seed,n_rows,n_quads,S", [
    (0, 15, 11, 10), (1, 26, 0, 10), (2, 15, 11, 16), (3, 26, 0, 33),
    (4, 40, 20, 1), (5, 40, 40, 9)])
def test_hoisted_order_gives_the_per_sample_decisions(seed, n_rows, n_quads,
                                                      S):
    case = _random_case(seed, n_rows, n_quads, S)
    a = per_sample_order(*case)
    b = hoisted_order(*case)
    assert torch.equal(a, b)
    assert 0 < int(a.sum()) < S or S == 1   # the cases mix both outcomes
    # the lit count: S less the occluded samples, equal in float32 to S
    # less one for each of them
    lit = F(S)
    for bit in a.tolist():
        lit = F(lit - F(1.0)) if bit else lit
    assert lit == F(S - int(b.sum()))


def test_transcription_meets_dA_zero_and_glass():
    """The cases above reach the edges they are there for: a sample along
    z against an axis-aligned row (dA == 0 exactly; a triangle row refuses
    it, a quad row fails the strict t-window) and glass rows."""
    rows, n_quads, sph, start, dirs, r2 = _random_case(0, 15, 11, 10)
    flat = (rows[:, 9] == 0) & (rows[:, 10] == 1) & (rows[:, 11] == 0)
    assert flat.any() and (rows[:, 12] == -1.0).any()
    inv = _invariants(rows[flat], start)
    d = dirs[0]
    assert (-_dot(d, inv[0]) == 0).all()
    for quad in (True, False):
        assert not _sample(inv, torch.tensor(quad), d, _dot(d, d), r2).any()


# --------------------------------------------------------------------------
# On the card: K1 bit for bit against K3f
# --------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _both_kernels(scene, cfg, quads, row0=None, rows=None):
    outs = {}
    for kern in ("whole", "streamed"):
        outs[kern] = tfwd.render_fused_res(scene, cfg, row0, rows, quads,
                                           _kernel=kern)
    torch.cuda.synchronize()
    (img, packed, res), (img2, packed2, res2) = outs["whole"], outs["streamed"]
    assert torch.equal(img.view(torch.int32), img2.view(torch.int32))
    assert torch.equal(packed.view(torch.int32), packed2.view(torch.int32))
    for a, b in zip(res, res2):
        assert torch.equal(a, b)
    raw = tfwd.render_fused_raw(scene, cfg, row0, rows, quads)
    assert torch.equal(raw[0].view(torch.int32), img.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(trt.baseline_configs()))
def test_k1_equals_k3f_on_card_baselines(cuda_device, name):
    cfg, scene, quads = _frame(name, 64)
    scene = scene.to(cuda_device)
    for q in (quads, None):
        _both_kernels(scene, cfg, q)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    dict(shadow_samples=1), dict(shadow_samples=16), dict(shadow_samples=33),
    dict(aa_x=1, aa_y=1), dict(aa_x=3, aa_y=3), dict(aa_x=4, aa_y=4),
    dict(width=50, height=20), dict(width=37, height=9, aa_x=3, aa_y=3,
                                    shadow_samples=33)])
def test_k1_equals_k3f_on_card_cases(cuda_device, kw):
    scene = trt.cornell_box(device=cuda_device)
    cfg = trt.RenderConfig(**{"width": 64, "height": 64, **kw})
    _both_kernels(scene, cfg, detect_shadow_quads(scene))


@pytest.mark.cuda
def test_k1_equals_k3f_on_card_row_band(cuda_device):
    scene = trt.cornell_box(device=cuda_device)
    cfg = trt.RenderConfig(width=50, height=64)
    before = tfwd.LAUNCHES
    _both_kernels(scene, cfg, detect_shadow_quads(scene), row0=13, rows=27)
    assert tfwd.LAUNCHES == before + 2
    assert tfwd.blocks_per_sm(scene, cfg, detect_shadow_quads(scene)) >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("quads", [True, False], ids=["quads", "triangles"])
@pytest.mark.parametrize("samples", [1, 3, 4, 5, 8, 9, 10])
@pytest.mark.parametrize("n_tri", [26, 600])
def test_k3f_chunked_shadow_pass_equals_k1_on_card(cuda_device, n_tri,
                                                   samples, quads):
    """K3f sweeps the occlusion table once per chunk of samples (4), K1
    scans its rows once per chunk of 8: image, pack and record bit for bit
    K1's, on both sides of either chunk's edge (1, 3, 4, 5, 8, 9 and 10
    samples), with the quad rows and without."""
    from uob_raytracer_tpu_torch.debug import dense_scene
    scene = dense_scene(n_tri, device=cuda_device)
    cfg = trt.RenderConfig(width=64, height=48, shadow_samples=samples,
                           bounces=2)
    _both_kernels(scene, cfg, detect_shadow_quads(scene) if quads else None)


@pytest.mark.cuda
@pytest.mark.parametrize("samples", [3, 10])
def test_k3f_within_the_parity_budget_on_card(cuda_device, samples):
    """K3f on a scene only it takes (1,100 triangles) against its plain
    version: the image within ``assert_images_match``'s budget (PARITY.md),
    the pack exact, the record within 0.5%."""
    from uob_raytracer_tpu_torch.debug import dense_scene
    scene = dense_scene(1100, device=cuda_device)
    cfg = trt.RenderConfig(width=96, height=20, shadow_samples=samples,
                           bounces=2)
    assert tfwd.use_streamed(scene.num_triangles, scene.num_spheres)
    ref, _, ref_res = tfwd.render_fused_res_plain(scene, cfg)
    img, packed, res = tfwd.render_fused_res(scene, cfg)
    torch.cuda.synchronize()
    assert_images_match(img.cpu().numpy(), ref.cpu().numpy(),
                        what=f"K3f S={samples}")
    assert torch.equal(packed.view(torch.int32),
                       pack_argb(img).view(torch.int32))
    for a, b in zip(res, ref_res):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert (a != b).float().mean() <= 0.005
