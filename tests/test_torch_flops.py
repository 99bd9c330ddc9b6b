"""Port tests: the roofline slice (``uob_raytracer_tpu_torch/flops.py``, K6
``kernels/peak.py``, K7 ``kernels/bwd_twin.py``) against the JAX package's
``uob_raytracer_tpu/flops.py``, on the CPU.

The analytic counts equal the JAX functions on the five baseline configs
and on a bounce record made from a seed with numpy. The calibration bodies
are held bit for bit: the port's bwdmix body against JAX's
``_bwdmix_iter`` run eagerly, op by op; the mix, add and fma chains against
a numpy transcription of the JAX kernel's body, written out below. The SASS
and ptxas parsers read short listings written into the test. The twin's
sizing meets the JAX test's own targets (``tests/test_flops.py:121-130``),
and its plain version visits every object exactly as often as the JAX
package's decision record says. Tests marked ``cuda`` launch the kernels
and skip without a card: K6 against its plain version (bit-equal; fma
within 1 ulp), the census probe's SASS against the JAX census of the same
body, K7 against its plain version launch by launch, in one launch and
split as K2 splits (sums within 1e-5 of the sum of the terms' magnitudes,
visits exact, the image bit-equal; the free twin's list K2f's). The
split twin's own CPU tests are ``tests/test_torch_k7.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import uob_raytracer_tpu as jrt
from uob_raytracer_tpu import flops as jflops
from uob_raytracer_tpu.kernels.render_fwd import render_fused_res as j_render_res
import uob_raytracer_tpu_torch as trt
from uob_raytracer_tpu_torch import flops
from uob_raytracer_tpu_torch.kernels import bwd_twin, peak, render_bwd
from uob_raytracer_tpu_torch.ops.replay import Residuals, residuals_from_numpy

F = np.float32
# the JAX test's twin config and targets (tests/test_flops.py:117-124)
TWIN_CFG = dict(width=128, height=16, aa_x=2, aa_y=2, shadow_samples=2,
                bounces=1)
TWIN_TARGETS = dict(target_per_lane=800.0, target_depth=200.0,
                    target_wdepth=290.0, slow_per_lane=14.0)


@pytest.fixture(scope="module")
def twin_case():
    """The JAX package's decision record of the Cornell box at the JAX
    test's twin config (its Pallas kernel, run as its own tests run it),
    and the port's scene, config and record built from it."""
    jcfg = jrt.RenderConfig(**TWIN_CFG)
    _, _, jres = j_render_res(jrt.cornell_box(), jcfg)
    arrays = tuple(np.asarray(x) for x in (jres.prim_id, jres.lit_cnt,
                                           jres.bounce_id))
    scene = trt.cornell_box(device="cpu")
    cfg = trt.RenderConfig(**TWIN_CFG)
    return scene, cfg, residuals_from_numpy(*arrays, device="cpu"), arrays


# ---------------------------------------------------------------------------
# The analytic counts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(trt.baseline_configs()))
def test_op_counts_match_jax(name):
    cfg, jcfg = trt.baseline_configs()[name], jrt.baseline_configs()[name]
    fracs = [0.3 * 0.5 ** b for b in range(cfg.bounces)]
    for n_tri, n_sph in ((26, 2), (600, 0)):
        for f in (None, fracs):
            assert (flops.forward_ops(cfg, n_tri, n_sph, f)
                    == jflops.forward_ops(jcfg, n_tri, n_sph, f))
            assert (flops.backward_ops(cfg, n_tri, n_sph, f)
                    == jflops.backward_ops(jcfg, n_tri, n_sph, f))


def test_bounce_tile_fracs_match_jax():
    """The same bounce record (ragged 20x200 frame, so tiles are padded)
    given to both as one numpy array; the port also takes a tensor."""
    rng = np.random.RandomState(3)
    bid = np.where(rng.uniform(size=(3, 4, 20, 200)) < 0.02,
                   rng.randint(0, 28, size=(3, 4, 20, 200)), -1).astype(np.int32)
    bid[0, :, :8] = -1               # a row of tiles idle at step 0
    bid[2] = -1                      # a step no ray runs
    res = Residuals(None, None, bid)
    want = jflops.bounce_tile_fracs_from_residuals(res, 3)
    assert flops.bounce_tile_fracs_from_residuals(res, 3) == want
    tres = Residuals(None, None, torch.from_numpy(bid))
    assert flops.bounce_tile_fracs_from_residuals(tres, 3) == want
    assert want == [pytest.approx(4 / 6), 1.0, 0.0]
    assert flops.bounce_tile_fracs_from_residuals(res, 0) == []


def test_bound_uses_the_data_sheet_unless_given_a_rate():
    assert flops.bound(3.35e9, 1.0) == (pytest.approx(1.0), "bytes")
    assert flops.bound(1.0, 67e9) == (pytest.approx(1.0), "operations")
    assert flops.bound(1.0, 67e9, peak_fp32=33.5e12) == (
        pytest.approx(2.0), "operations")


# ---------------------------------------------------------------------------
# The calibration bodies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 16, 17])
def test_bwdmix_iter_bit_equal_to_jax(k):
    """20 iterations of the port's bwdmix body against the JAX package's
    ``_bwdmix_iter`` (every slow-op slot appears at K = 16 and 17)."""
    rng = np.random.RandomState(k)
    x = rng.uniform(0.1, 1.2, 96).astype(F)
    acc = (rng.standard_normal((k, 96)) * 2.0).astype(F)
    jx, jaccs = jnp.asarray(x), tuple(jnp.asarray(a) for a in acc)
    tx, tacc = torch.from_numpy(x), torch.from_numpy(acc)
    for _ in range(20):
        jaccs = jflops._bwdmix_iter(jaccs, jx)
        tacc = peak.bwdmix_iter(tacc, tx)
        np.testing.assert_array_equal(
            tacc.numpy(), np.stack([np.asarray(a) for a in jaccs]))


def _numpy_chain(mode: str, k: int, x):
    """A numpy transcription of the JAX kernel's chains
    (uob_raytracer_tpu/flops.py:490-530: init 492, fma 495-496, add
    497-498, mix 501-523, the sum 527-529), float32 operation by operation.
    The port's fma is one rounding (``__fmaf_rn``), where the JAX body
    rounds the product and the sum: here in float64, rounded once."""
    h = F(0.5)
    accs = [x * F(1.0 + 1e-7 * i) for i in range(k)]
    for _ in range(peak.INNER):
        out = []
        for a in accs:
            if mode == "fma":
                out.append((a.astype(np.float64) * x + np.float64(F(1e-7)))
                           .astype(F))
            elif mode == "add":
                out.append(a + x)
            else:
                t1 = a * x
                t2 = t1 * x
                t3 = a * h
                s1 = t1 + t2
                m1 = s1 >= t3
                m2 = t2 < a
                m3 = m1 & m2
                d = t3 - t1
                n1 = -d
                w = np.where(m3, n1, t2)
                t4 = w * x
                t5 = t4 * h
                s2 = w + t5
                m4 = s2 != x
                t6 = np.maximum(s2, t4)
                out.append(np.where(m4, t6, a) * F(0.999))
        accs = out
    total = accs[0]
    for a in accs[1:]:
        total = total + a
    return total


@pytest.mark.parametrize("mode", ["fma", "add", "mix"])
@pytest.mark.parametrize("k", [1, 4])
def test_plain_chains_match_numpy_transcription(mode, k):
    base = 0.001 if mode == "add" else 0.99999
    x = (base * (1.0 - 1e-4 * np.random.RandomState(k).uniform(size=64))
         ).astype(F)
    got = peak.peak_chain(mode, k, torch.from_numpy(x))      # CPU: plain
    np.testing.assert_array_equal(got.numpy(), _numpy_chain(mode, k, x))
    assert np.isfinite(got.numpy()).all()


def test_census_probe_plain():
    """The body of tests/test_flops.py:31-38 in numpy, op by op."""
    x = np.linspace(0.5, 1.5, 40, dtype=F)
    y = x
    for _ in range(5):
        y = y * x
    for _ in range(3):
        y = y + x
    np.testing.assert_array_equal(peak.census_probe(torch.from_numpy(x)), y)
    assert peak.PROBE_LAUNCHES == 0 and peak.LAUNCHES == 0


# ---------------------------------------------------------------------------
# The SASS and ptxas parsers
# ---------------------------------------------------------------------------

LISTING = """
	code for sm_90a
		Function : _ZN12_GLOBAL__N_110peak_chainILi1ELi2EEEvPKfPfi
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                 /* 0x00000a00ff017b82 */
                                                                          /* 0x000fe40000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;                     /* 0x0000000000007919 */
        /*0020*/                   ISETP.GE.AND P0, PT, R0, UR4, PT ;
        /*0030*/               @P0 EXIT ;
        /*0040*/                   LDG.E R2, desc[UR4][R2.64] ;
        /*0050*/                   FMUL R4, R2, 1 ;
        /*0060*/                   FMUL R5, R2, 1.0000001192092895508 ;
        /*0070*/                   MOV R6, 0x1f4 ;
.L_x_0:
        /*0080*/                   IADD3 R6, R6, -0x1, RZ ;
        /*0090*/                   FADD R4, R2, R4 ;
        /*00a0*/                   FADD R5, R2, R5 ;
        /*00b0*/                   ISETP.NE.AND P0, PT, R6, RZ, PT ;
        /*00c0*/              @!P0 BRA `(.L_x_0) ;
        /*00d0*/                   FADD R4, R4, R5 ;
        /*00e0*/                   STG.E desc[UR4][R2.64], R4 ;
        /*00f0*/                   EXIT ;
.L_x_1:
        /*0100*/                   BRA `(.L_x_1);
        /*0110*/                   NOP;
		..........

		Function : _ZN12_GLOBAL__N_119census_probe_kernelEPKfPfi
        /*0000*/                   SHFL.BFLY PT, R3, R2, 0x10, 0x1f ;
        /*0010*/                   UIADD3 UR4, UR4, 0x1, URZ ;
        /*0020*/                   FSETP.GEU.AND P1, PT, R2, RZ, PT ;
        /*0030*/                   MUFU.RSQ R3, R2 ;
        /*0040*/                   HFMA2.MMA R5, -RZ, RZ, 0, 0 ;
        /*0050*/                   EXIT ;
"""


def test_sass_parser_counts_classes_and_loops():
    funcs = flops.parse_sass(LISTING)
    assert len(funcs) == 2
    c = flops.sass_census("peak_chain<1, 2>", listing=LISTING)
    assert c["function"].endswith("peak_chainILi1ELi2EEEvPKfPfi")
    assert (c["fp32"], c["int"], c["mem"], c["control"], c["other"]) == (
        5, 3, 3, 5, 2)
    assert c["opcodes"]["FADD"] == 3 and c["opcodes"]["FMUL"] == 2
    assert c["total"] == 18
    (loop,) = c["loops"]                 # the padding BRA is no loop
    assert (loop["start"], loop["end"]) == (0x80, 0xc0)
    assert (loop["fp32"], loop["int"], loop["control"], loop["total"]) == (
        2, 2, 1, 5)
    p = flops.sass_census("census_probe_kernel", listing=LISTING)
    assert (p["fp32"], p["mem"], p["int"], p["other"], p["control"]) == (
        2, 1, 1, 1, 1)
    assert p["loops"] == []
    with pytest.raises(LookupError):
        flops.sass_census("peak_chain<1, 4>", listing=LISTING)


@pytest.mark.parametrize("name,frag", [
    ("render_bwd_kernel", "17render_bwd_kernelE"),
    ("render_bwd_kernel<false>", "17render_bwd_kernelILb0EE"),
    ("peak_chain<2, 16>", "10peak_chainILi2ELi16EE"),
    ("bwd_twin_kernel<64>", "15bwd_twin_kernelILi64EE"),
    (peak.symbol("bwdmix", 32), "10peak_chainILi3ELi32EE"),
    (bwd_twin.symbol(64), "21bwd_twin_chain_kernelILi64EE"),
    (bwd_twin.symbol(16, "free"), "20bwd_twin_free_kernelILi16EE"),
    (bwd_twin.SPLITS["no_search"][1], "21bwd_twin_split_kernelILi3ELi3EE"),
])
def test_mangled_fragment(name, frag):
    assert flops.mangled_fragment(name) == frag


def test_ptxas_parser():
    log = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_117render_bwd_kernelEPKfS2_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_117render_bwd_kernelEPKfS2_
    864 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 864 bytes cumulative stack size, 448 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115bwd_twin_kernelILi24EEvPKf' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_115bwd_twin_kernelILi24EEvPKf
    800 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 255 registers, 16 bytes smem, 448 bytes cmem[0]
"""
    funcs = flops.parse_ptxas(log)
    k2 = funcs["_ZN12_GLOBAL__N_117render_bwd_kernelEPKfS2_"]
    assert k2 == {"registers": 168, "shared_bytes": 0, "stack_bytes": 864,
                  "spill_stores": 0, "spill_loads": 0}
    tw = funcs["_ZN12_GLOBAL__N_115bwd_twin_kernelILi24EEvPKf"]
    assert (tw["registers"], tw["spill_stores"], tw["spill_loads"],
            tw["shared_bytes"]) == (255, 8, 12, 16)


# ---------------------------------------------------------------------------
# The structure twin
# ---------------------------------------------------------------------------

def test_twin_sizing_meets_the_jax_tests_targets(twin_case, monkeypatch):
    scene, cfg, res, _ = twin_case
    live = flops.chain_steps(scene, cfg, res) / res.prim_id.numel()
    assert 0.0 < live < 1.0
    twin = flops.build_bwd_structure_twin(scene, cfg, res, **TWIN_TARGETS,
                                          live=live, target_registers=0)
    assert 0.9 < twin["census_match"] < 1.1
    assert twin["depth"] > 0.9 * twin["target_depth"]
    assert twin["wdepth"] > twin["depth"]          # divides on the path
    assert twin["n_pool"] == 0 and twin["registers"] is None
    assert twin["census_per_lane"] == pytest.approx(flops.twin_ops_per_ray(
        twin["n_step"], twin["slots"], 0, live, cfg.aa_rays), abs=0.05)

    # a register target picks the smallest clean instance that reaches it
    regs = dict(zip(bwd_twin.POOLS, (120, 150, 170, 200, 240)))

    def fake(kernel):
        n = int(kernel.split("<")[1].rstrip(">"))
        return {"registers": regs[n], "spill_stores": 8 if n == 128 else 0,
                "spill_loads": 0}

    monkeypatch.setattr(flops, "kernel_resources", fake)
    pooled = flops.build_bwd_structure_twin(scene, cfg, res, **TWIN_TARGETS,
                                            live=live, target_registers=168)
    assert pooled["n_pool"] == 64 and pooled["registers"] == 170
    assert 0.9 < pooled["census_match"] < 1.1
    assert sum(pooled["slots"]) < sum(twin["slots"])   # the fold paid back
    top = flops.build_bwd_structure_twin(scene, cfg, res, **TWIN_TARGETS,
                                         live=live, target_registers=250)
    assert top["n_pool"] == 96                      # 128 spills


def test_twin_visits_match_the_jax_record(twin_case):
    """The twin's plain version visits each object once per site of the
    JAX package's record that hit it; its sums and image are finite; the
    wrapper on the CPU runs the plain version and launches nothing."""
    scene, cfg, res, (pid, _, bid) = twin_case
    targets = flops.bwd_twin_targets(scene, cfg, res)
    twin = flops.build_bwd_structure_twin(scene, cfg, res, **targets,
                                          target_registers=0)
    out = twin["run_plain"]()
    n_obj = scene.num_triangles + scene.num_spheres
    ids = np.concatenate([pid[pid >= 0], bid[bid >= 0]])
    np.testing.assert_array_equal(out["visits"].numpy(),
                                  np.bincount(ids, minlength=n_obj))
    assert torch.isfinite(out["sums"]).all() and torch.isfinite(out["img"]).all()
    assert (out["abs_sums"] >= out["sums"].abs() - 1e-9).all()
    sums, img = twin["run"]()
    assert torch.equal(img, out["img"]) and bwd_twin.LAUNCHES == 0
    np.testing.assert_allclose(sums.numpy(), out["sums"].numpy(), rtol=1e-6)


def test_twin_sizing_is_refused_past_the_caps(twin_case):
    scene, cfg, res, _ = twin_case
    table = bwd_twin.twin_table(scene, cfg)
    g = torch.zeros((cfg.height, cfg.width, 3))
    bad = {"n_main": 2, "n_step": 1, "slots": [17, 1], "divs": [[], []],
           "n_pool": 0}
    with pytest.raises(ValueError, match="caps"):
        bwd_twin.bwd_twin(table, g, res, cfg, bad)
    with pytest.raises(ValueError, match="caps"):
        bwd_twin.bwd_twin(table, g, res, cfg, dict(bad, slots=[1, 1],
                                                    n_pool=10))
    assert table.shape == (28, 17) and torch.equal(
        table[:, 15], torch.cat([scene.tri_mat, scene.sph_mat]))


# ---------------------------------------------------------------------------
# The counts that explain K2's and K5's gaps, against brute-force loops
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cornell_16():
    """A 16x16 Cornell record at full_1024's settings (2x2 AA, 10 bounces):
    the port's plain forward on the CPU."""
    from uob_raytracer_tpu_torch.kernels.render_fwd import render_fused_res_plain
    scene = trt.cornell_box(device="cpu")
    cfg = trt.RenderConfig(width=16, height=16)
    return scene, cfg, render_fused_res_plain(scene, cfg)[2]


def _chain_of(scene, cfg, res):
    """[A][pixel] -> has a chain, ray by ray."""
    mat = torch.cat([scene.tri_mat, scene.sph_mat]).tolist()
    pid = res.prim_id.reshape(res.prim_id.shape[0], -1).tolist()
    return [[cfg.bounces > 0 and i >= 0 and mat[i] <= 0.0 for i in row]
            for row in pid]


def test_chain_share_matches_brute_force(cornell_16):
    scene, cfg, res = cornell_16
    chain = _chain_of(scene, cfg, res)
    A, n = len(chain), len(chain[0])
    pix = [any(chain[a][p] for a in range(A)) for p in range(n)]
    warps = [any(pix[w:w + 32]) for w in range(0, n, 32)]
    got = flops.chain_share(scene, cfg, res)
    assert got["rays"] == sum(map(sum, chain)) / (A * n)
    assert got["pixels"] == sum(pix) / n
    assert got["warps"] == sum(warps) / len(warps)
    assert 0.0 < got["rays"] < got["pixels"] <= got["warps"] < 1.0
    assert got["steps_per_ray"] == flops.chain_steps(scene, cfg, res) / (A * n)
    none = flops.chain_share(scene, trt.RenderConfig(width=16, height=16,
                                                     bounces=0), res)
    assert none["rays"] == none["pixels"] == none["warps"] == 0.0


def _distinct(ids):
    return len({i for i in ids if i >= 0})


@pytest.mark.parametrize("scheme", ["pr6", "pr7"])
def test_scatter_work_matches_brute_force(cornell_16, scheme):
    scene, cfg, res = cornell_16
    A = res.prim_id.shape[0]
    pid = res.prim_id.reshape(A, -1).tolist()
    n = len(pid[0])
    bid = res.bounce_id.reshape(cfg.bounces, A, n).tolist()
    chain = _chain_of(scene, cfg, res)
    pix = [any(chain[a][p] for a in range(A)) for p in range(n)]
    distinct = []          # per warp-site that scatters

    def site(ids):
        d = _distinct(ids)
        if d:
            distinct.append(d)

    def carried(warps_pixels, ids_of):
        # a lane carries its primary row while the object repeats
        for lanes in warps_pixels:
            carry = [-1] * len(lanes)
            for a in range(A):
                new = [ids_of(a, p) for p in lanes]
                site([c if c >= 0 and x >= 0 and x != c else -1
                      for c, x in zip(carry, new)])
                carry = [x if x >= 0 else c for c, x in zip(carry, new)]
            site(carry)

    if scheme == "pr6":
        n_warps = 0
        for w in range(0, n, 32):
            lanes = range(w, min(w + 32, n))
            n_warps += 1
            for a in range(A):
                site([pid[a][p] for p in lanes])
                for k in range(cfg.bounces):
                    site([bid[k][a][p] for p in lanes])
    else:
        free = [list(range(w, min(w + 32, n))) for w in range(0, n, 32)]
        carried(free, lambda a, p: -1 if pix[p] else pid[a][p])
        listed = [p for p in range(n) if pix[p]]
        chained = [listed[w:w + 32] for w in range(0, len(listed), 32)]
        for lanes in chained:
            for a in range(A):
                site([pid[a][p] for p in lanes])
                for k in range(cfg.bounces):
                    site([bid[k][a][p] for p in lanes])
        n_warps = len(free) + len(chained)
    per_id, cam = 1 + 16 * 5, 21 * 5
    got = flops.scatter_work(scene, cfg, res, scheme)
    assert got["sites"] == len(distinct)
    assert got["distinct"] == sum(distinct)
    assert got["scatter"] == per_id * sum(distinct)
    assert got["camera"] == cam * n_warps
    assert got["per_ray"] == (got["scatter"] + got["camera"]) / (A * n)


def test_scatter_work_pr7_issues_fewer_shuffles(cornell_16):
    scene, cfg, res = cornell_16
    old, new = (flops.scatter_work(scene, cfg, res, s) for s in ("pr6", "pr7"))
    assert new["scatter"] < old["scatter"] and new["sites"] < old["sites"]


def occlusion_batch(kind: str, n_rays: int, n_tri: int, seed: int = 0):
    """A shadow-ray batch and a shard, made with numpy: rays from z = 0 up
    to a light at z = 1, filler rows off every path (z = 3), and
    "all_lit": nothing else; "row0": row 0 covers every ray;
    "alternating": even rays meet row n_tri // 2, odd rays nothing;
    "neighbours": even rays meet row 3, odd rays only row n_tri - 2 (a
    neighbour's occluder is not theirs), and row n_tri - 1, glass, covers
    all and casts no shadow; "random": random triangles, a tenth glass.
    Returns (v0, e1, e2, mat, start, d, radius_sq) as CPU tensors."""
    rng = np.random.RandomState(seed)
    start = np.zeros((n_rays, 3), F)
    start[:, 0] = rng.uniform(-0.9, 0.9, n_rays)
    start[:, 1] = rng.uniform(-0.4, 0.4, n_rays)
    if kind in ("alternating", "neighbours"):
        start[0::2, 0] = -np.abs(start[0::2, 0]) - 0.05
        start[1::2, 0] = np.abs(start[1::2, 0]) + 0.05
    d = np.zeros((n_rays, 3), F)
    d[:, 2] = 1.0
    d[:, :2] = rng.uniform(-0.01, 0.01, (n_rays, 2))
    r2 = np.sum(d * d, axis=1).astype(F)
    c = rng.uniform(-1, 1, (n_tri, 3)).astype(F)
    c[:, 2] = 3.0
    v = np.stack([c, c + F([0.01, 0, 0]), c + F([0, 0.01, 0])], 1)
    mat = np.ones(n_tri, F)
    cover = np.array([[-9, -9, 0.5], [30, -9, 0.5], [-9, 30, 0.5]], F)
    left = np.array([[0, -9, 0.5], [0, 9, 0.5], [-20, 0, 0.5]], F)
    if kind == "row0":
        v[0] = cover
    elif kind == "alternating":
        v[n_tri // 2] = left
    elif kind == "neighbours":
        v[3] = left - F([0, 0, 0.1])
        v[n_tri - 2] = cover + F([0, 0, 0.1])
        v[n_tri - 1] = cover
        mat[n_tri - 1] = -1.0
    elif kind == "random":
        c = rng.uniform(-1, 1, (n_tri, 3)).astype(F)
        c[:, 2] = rng.uniform(0.1, 0.9, n_tri)
        v = np.stack([c, c + rng.uniform(0.05, 0.4, (n_tri, 3)).astype(F),
                      c + rng.uniform(0.05, 0.4, (n_tri, 3)).astype(F)], 1)
        mat = np.where(rng.uniform(size=n_tri) < 0.1, -1.0, 1.0).astype(F)
    t = [torch.from_numpy(np.ascontiguousarray(x)) for x in (
        v[:, 0], v[:, 1] - v[:, 0], v[:, 2] - v[:, 0], mat, start, d, r2)]
    return tuple(t)


OCC_CASES = [("all_lit", 70, 40), ("row0", 70, 40), ("alternating", 70, 40),
             ("neighbours", 64, 300), ("random", 45, 37)]


@pytest.mark.parametrize("kind,n_rays,n_tri", OCC_CASES)
def test_first_occluder_matches_brute_force(kind, n_rays, n_tri):
    from uob_raytracer_tpu_torch.kernels.partial import _shard
    from uob_raytracer_tpu_torch.ops.intersect import tris_occlude
    v0, e1, e2, mat, start, d, r2 = occlusion_batch(kind, n_rays, n_tri)
    want = []
    for i in range(n_rays):
        first = n_tri
        for j in range(n_tri):
            ds = _shard(v0[j:j + 1], e1[j:j + 1], e2[j:j + 1], v0[j:j + 1],
                        v0[j:j + 1], mat[j:j + 1])
            if bool(tris_occlude(ds, start[i:i + 1], d[i:i + 1], r2[i:i + 1])):
                first = j
                break
        want.append(first)
    got = flops.first_occluder(v0, e1, e2, mat, start, d, r2)
    assert got.tolist() == want
    expect = {"all_lit": {n_tri}, "row0": {0},
              "alternating": {n_tri // 2, n_tri}, "neighbours": {3, n_tri - 2}}
    if kind in expect:
        assert set(want) == expect[kind]


def _lanes_brute(first, n_tri, scheme, tile=128, group=4):
    """Lane-rows issued, warp by warp and tile by tile
    (``flops.occluded_lanes``)."""
    need = [n_tri if f >= n_tri else f + 1 for f in first]
    if scheme == "pr6":
        return sum(32 * max(need[w:w + 32]) for w in range(0, len(need), 32))
    issued = 0
    for w in range(0, len(first), 32):
        for base in range(0, n_tri, tile):
            n_rows = min(tile, n_tri - base)
            longest = 0
            for f in first[w:w + 32]:
                if f < base:          # stopped in an earlier tile
                    continue
                rows = min(f - base + 1, n_rows)
                longest = max(longest, -(-rows // group) * group)
            issued += 32 * longest
    return issued


@pytest.mark.parametrize("scheme", ["pr6", "pr7"])
@pytest.mark.parametrize("kind", ["all_lit", "row0", "alternating", "mixed"])
def test_occluded_lanes_matches_brute_force(kind, scheme):
    n_tri, n = 300, 300
    rng = np.random.RandomState(5)
    first = {"all_lit": [n_tri] * n, "row0": [0] * n,
             "alternating": [n_tri if i % 2 else 17 for i in range(n)],
             "mixed": list(np.where(rng.uniform(size=n) < 0.4,
                                    rng.randint(0, n_tri, n), n_tri))}[kind]
    got = flops.occluded_lanes(torch.tensor(first), n_tri, scheme, tile=64)
    issued = _lanes_brute(first, n_tri, scheme, tile=64)
    need = sum(n_tri if f >= n_tri else f + 1 for f in first)
    lit = sum(f >= n_tri for f in first)
    assert got["issued"] == issued and got["rows"] == need
    assert got["used"] == need / issued
    assert got["row_order"] == need / (lit * n_tri + (n - lit))
    if kind == "all_lit":   # tiles of 64 rows: 300 = 4 x 64 + 44, whole steps
        assert got["used"] == pytest.approx(n / (-(-n // 32) * 32))
    if kind == "row0":
        assert got["row_order"] == 1.0


# ---------------------------------------------------------------------------
# On the card (skip without one)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", peak.MODES)
def test_peak_chains_on_card(cuda_device, mode):
    base = 0.001 if mode == "add" else 0.99999
    x = torch.from_numpy((base * (1.0 - 1e-4 * np.random.RandomState(5)
                                  .uniform(size=4096))).astype(F))
    for k in peak.KS:
        got = peak.peak_chain(mode, k, x.to(cuda_device)).cpu()
        want = peak.peak_chain_plain(mode, k, x)
        if mode == "fma":
            ulps = (got.view(torch.int32) - want.view(torch.int32)).abs()
            assert int(ulps.max()) <= 1, (mode, k)
        else:
            assert torch.equal(got, want), (mode, k)
        # one trip of the loop: UNROLL[k] iterations of k single-op bodies
        loop = max(flops.sass_census(peak.symbol(mode, k))["loops"],
                   key=lambda lp: lp["fp32"])
        if mode in ("fma", "add"):
            op = "FFMA" if mode == "fma" else "FADD"
            assert loop["opcodes"].get(op) == k * peak.UNROLL[k], (mode, k)


@pytest.mark.cuda
def test_census_probe_on_card(cuda_device, cornell):
    from test_flops import _tiny_pallas

    def kernel(x_ref, o_ref):       # tests/test_flops.py:31-38
        x = x_ref[...]
        y = x
        for _ in range(5):
            y = y * x
        for _ in range(3):
            y = y + x
        o_ref[...] = y

    jax_ops = jflops.census_kernel_ops(_tiny_pallas(kernel), cornell,
                                       while_weight=1.0,
                                       lanes_per_tile=8 * 128)["per_lane"]
    c = flops.sass_census("census_probe_kernel")
    assert (c["opcodes"].get("FMUL"), c["opcodes"].get("FADD")) == (5, 3)
    assert c["fp32"] == jax_ops == 8.0
    x = torch.linspace(0.5, 1.5, 1024)
    assert torch.equal(peak.census_probe(x.to(cuda_device)).cpu(),
                       peak.census_probe_plain(x))


@pytest.mark.cuda
def test_structure_twin_on_card(cuda_device, twin_case, monkeypatch):
    """K7 on the JAX test's twin record, each launch sized to K2's own
    registers: in one launch (the chain twin over every pixel), then split
    as K2 splits (``SPLIT_RAYS`` 0): each launch's sums within 1e-5 of the
    sum of its terms' magnitudes, visits exact, the image bit-equal to the
    plain version, and the free twin's list bit-equal to K2f's."""
    scene, cfg, res, arrays = twin_case
    scene = trt.cornell_box(device=cuda_device)
    res = residuals_from_numpy(*arrays, device=cuda_device)
    n_obj = scene.num_triangles + scene.num_spheres

    def hold(sums, ref):
        err = ((sums.double() - ref["sums"]).abs()
               / ref["abs_sums"].clamp(min=1e-30)).max().item()
        assert err <= 1e-5
        visits = sums[:n_obj * 16].reshape(n_obj, 16)[:, 15].round().long()
        assert torch.equal(visits, ref["visits"])

    for split in (False, True):
        if split:
            monkeypatch.setattr(render_bwd, "SPLIT_RAYS", 0)
        twin = flops.build_bwd_structure_twin(scene, cfg, res)
        assert twin["split"] == split
        before = (bwd_twin.LAUNCHES, bwd_twin.FREE_LAUNCHES)
        parts, img = twin["run"](parts=True)
        torch.cuda.synchronize()
        assert (bwd_twin.LAUNCHES - before[0],
                bwd_twin.FREE_LAUNCHES - before[1]) == (1, int(split))
        ref = twin["run_plain"]()
        assert torch.equal(img, ref["img"])
        for kind, v in ref["launches"].items():
            hold(parts[kind], v)
        sums, _ = twin["run"]()
        hold(sums, ref)
        if split:
            assert torch.equal(parts["list"],
                               bwd_twin.k2_free_list(scene, cfg, res))
