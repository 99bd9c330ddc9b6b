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
body, K7 against its plain version (sums within 1e-5 of the sum of the
terms' magnitudes, visits exact).
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
from uob_raytracer_tpu_torch.kernels import bwd_twin, peak
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
    (bwd_twin.symbol(64), "15bwd_twin_kernelILi64EE"),
    (peak.symbol("bwdmix", 32), "10peak_chainILi3ELi32EE"),
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
def test_structure_twin_on_card(cuda_device, twin_case):
    scene, cfg, res, arrays = twin_case
    scene = trt.cornell_box(device=cuda_device)
    res = residuals_from_numpy(*arrays, device=cuda_device)
    targets = flops.bwd_twin_targets(scene, cfg, res)
    k2 = flops.kernel_resources("render_bwd_kernel<false>")["registers"]
    twin = flops.build_bwd_structure_twin(scene, cfg, res, **targets,
                                          target_registers=k2)
    sums, img = twin["run"]()
    ref = twin["run_plain"]()
    err = ((sums.double() - ref["sums"]).abs()
           / ref["abs_sums"].clamp(min=1e-30)).max().item()
    assert err <= 1e-5
    n_obj = scene.num_triangles + scene.num_spheres
    visits = sums[:n_obj * 16].reshape(n_obj, 16)[:, 15].round().long()
    assert torch.equal(visits, ref["visits"])
    assert torch.allclose(img, ref["img"], rtol=1e-6, atol=0)
