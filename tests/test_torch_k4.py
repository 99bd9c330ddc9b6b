"""Port tests: K4, the per-shard nearest-hit kernel (``csrc/partial.cu``:
``nearest_tris_kernel``), as redesigned for Hopper: its row test, its
thread groups and their merge, its grid.

On the CPU (no card, no nvcc) the kernel's arithmetic and order are held
in torch float32, bit for bit:

- the row test takes detA = det3(nd, e1, e2) and the t numerator
  det3(b, e1, e2) from the row's cofactors C of (e1, e2), three products
  and two sums each: ``cofactor_det(a, cofactors(b, c))`` is det3 bit for
  bit on every draw. The form -dot(d, cross(e1, e2)) equals det3 in value
  but not always in the sign of a zero (a pinned case), which is why the
  kernel keeps det3's middle cofactor and not E's;
- a model of the G-group scan (group g tests slice g of every 128-row
  tile in row order with the strict <, the groups' winners merged by
  (t, row)) gives ``nearest_tris_plain``'s ids and t, and ``_tri_tuv``'s
  u and v at the winning row, for G = 1, 2, 4 (the kernel runs G = 4,
  ``partial.NEAR_GROUPS``), on the Cornell rows, the 600-row dense shard
  and a table of duplicated rows (exact ties);
- the launcher's grid (``partial.nearest_grid``) on the frames the tp
  route gives it, and the kernel source's constants against the
  wrapper's.

Tests marked ``cuda`` launch the kernel against the plain version (ids,
mat, nrm, rgb equal; t and pos within 1e-5) and twice, bit for bit; they
skip without a card. This file imports no JAX: the JAX
package's partial-scan kernels are held to the port in
``tests/test_torch_partial.py``.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import example, given, settings, strategies as st
from hypothesis.extra.numpy import arrays

import uob_raytracer_tpu_torch as trt
from uob_raytracer_tpu_torch.kernels import partial
from uob_raytracer_tpu_torch.ops.intersect import _tri_tuv, prepare_scene
from uob_raytracer_tpu_torch.ops.math3 import cross3, det3, dot3

TINY = np.finfo(np.float32).tiny           # smallest normal float32
SUB = np.float32(1e-40)                    # a subnormal
_SETTINGS = dict(max_examples=60, deadline=None)

# float32 draws with zeros of both signs, subnormals and a wide spread of
# exponents (2^-100 ... 2^40): a determinant's three-fold products stay
# finite
spread = st.one_of(
    st.sampled_from([0.0, -0.0, float(SUB), -float(SUB), float(TINY), 1.0,
                     -1.0]),
    st.floats(-2.0 ** 40, 2.0 ** 40, allow_nan=False, width=32),
    st.floats(-float(np.float32(1e-30)), float(np.float32(1e-30)),
              allow_nan=False, width=32))
vecs = arrays(np.float32, (16, 3), elements=spread)


def cofactors(b, c):
    """The cofactors of rows (b, c) along which det3 expands its first row:
    ``load_near_tile``'s C, term by term."""
    return torch.stack([b[..., 1] * c[..., 2] - b[..., 2] * c[..., 1],
                        b[..., 0] * c[..., 2] - b[..., 2] * c[..., 0],
                        b[..., 0] * c[..., 1] - b[..., 1] * c[..., 0]], dim=-1)


def cofactor_det(a, C):
    """``csrc/partial.cu:cofactor_det``: det3(a, b, c) from cofactors(b, c)."""
    return a[..., 0] * C[..., 0] - a[..., 1] * C[..., 1] + a[..., 2] * C[..., 2]


def bits(x):
    return x.contiguous().view(torch.int32)


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


# --------------------------------------------------------------------------
# The row test's two determinants
# --------------------------------------------------------------------------

@settings(**_SETTINGS)
@given(d=vecs, b=vecs, e1=vecs, e2=vecs)
@example(d=np.full((16, 3), -0.0, np.float32), b=np.zeros((16, 3), np.float32),
         e1=np.float32([[1.0, 2.0, SUB]] * 16),
         e2=np.float32([[-0.0, TINY, 3.0]] * 16))
def test_cofactor_form_is_det3_bit_for_bit(d, b, e1, e2):
    """detA and the t numerator from the row's cofactors: det3's bits, the
    signs of zeros included, on every draw."""
    d, b, e1, e2 = _t(d, b, e1, e2)
    C = cofactors(e1, e2)
    for a in (-d, b):
        want = det3(a, e1, e2)
        got = cofactor_det(a, C)
        both_nan = torch.isnan(want) & torch.isnan(got)
        assert (both_nan | (bits(want) == bits(got))).all()


@settings(**_SETTINGS)
@given(d=vecs, b=vecs, e1=vecs, e2=vecs)
def test_e_form_is_det3_up_to_the_sign_of_zero(d, b, e1, e2):
    """det3(nd, e1, e2) == -dot(d, E) and det3(b, e1, e2) == dot(b, E), E =
    cross3(e1, e2): equal values, and the same bits wherever the value is
    not zero (det3's middle cofactor is -E.y but for the sign of a zero)."""
    d, b, e1, e2 = _t(d, b, e1, e2)
    E = cross3(e1, e2)
    for want, got in ((det3(-d, e1, e2), -dot3(d, E)),
                      (det3(b, e1, e2), dot3(b, E))):
        both_nan = torch.isnan(want) & torch.isnan(got)
        assert (both_nan | (want == got)).all()
        nonzero = (want != 0) & ~torch.isnan(want)
        assert torch.equal(bits(want)[nonzero], bits(got)[nonzero])


def test_e_form_differs_from_det3_in_a_zero_sign():
    """A pinned row where det3 gives -0 and the E form +0: e1 = (0, 1, 0),
    e2 = (0, 0, 1), so det3's middle cofactor e1.x e2.z - e1.z e2.x and E.y
    are both +0, and b = (-0, 5, -1). det3 sums -0 - (+0) + (-0) = -0; the
    E form -0 + (+0) + (-0) = +0. A t numerator of -0 against +0 would put
    -0 into a hit's t, so the kernel keeps det3's cofactors (and the
    parent's bits), not E."""
    b = torch.tensor([[-0.0, 5.0, -1.0]])
    e1 = torch.tensor([[0.0, 1.0, 0.0]])
    e2 = torch.tensor([[0.0, 0.0, 1.0]])
    want = det3(b, e1, e2)
    assert torch.equal(bits(want), bits(cofactor_det(b, cofactors(e1, e2))))
    e_form = dot3(b, cross3(e1, e2))
    assert want == e_form == 0.0
    assert torch.signbit(want) and not torch.signbit(e_form)


# --------------------------------------------------------------------------
# The G-group scan and its merge, modelled in torch
# --------------------------------------------------------------------------

def group_scan(v0, e1, e2, start, d, groups: int, tile: int = partial.THREADS):
    """(id, t, u, v) per ray as ``nearest_tris_kernel`` with ``groups``
    thread groups a ray finds them:
    each row's test from its cofactors, group g scanning the rows of slice
    g of every ``tile``-row tile in row order with the strict <, then the
    groups' winners merged by (t, row). id -1 and t 3e38 on a miss."""
    nd = -d[:, None, :]
    b = start[:, None, :] - v0[None]
    C = cofactors(e1, e2)[None]
    detA = cofactor_det(nd, C)
    degen = detA == 0
    recip = 1.0 / torch.where(degen, 1.0, detA)
    t = cofactor_det(b, C) * recip
    u = det3(nd, b, e2[None]) * recip
    v = det3(nd, e1[None], b) * recip
    ok = (t >= 0) & (u >= 0) & (v >= 0) & ((u + v) <= 1) & ~degen
    big = torch.tensor(3.0e38)
    rows = torch.arange(v0.shape[0])
    group = (rows % tile) // (tile // groups)
    n = start.shape[0]
    best = (torch.full((n,), -1), torch.full((n,), 3.0e38), torch.zeros(n),
            torch.zeros(n))
    for g in range(groups):
        mine = rows[group == g]                    # increasing row order
        if not mine.numel():                       # a slice past the table
            continue
        tg = torch.where(ok[:, mine] & (t[:, mine] < big), t[:, mine], big)
        k = torch.argmin(tg, dim=1)                # the first least t
        tk = tg.gather(1, k[:, None])[:, 0]
        hit = tk < big
        row = torch.where(hit, mine[k], -1)
        uk = u[:, mine].gather(1, k[:, None])[:, 0]
        vk = v[:, mine].gather(1, k[:, None])[:, 0]
        # the merge: the lower t, the lower row on equal t
        take = hit & ((tk < best[1]) | ((tk == best[1]) & (row < best[0])))
        best = (torch.where(take, row, best[0]), torch.where(take, tk, best[1]),
                torch.where(take, uk, best[2]), torch.where(take, vk, best[3]))
    return best


def dense_shard(n_tri: int, seed: int = 1):
    """``chip_smoke.dense_scene``'s table (the Cornell box plus random small
    triangles) on the CPU, as the shard's six leaves."""
    base = trt.cornell_box(device="cpu")
    rng = np.random.RandomState(seed)
    extra = n_tri - base.num_triangles
    c = (rng.uniform(-0.9, 0.9, (extra, 3)).astype(np.float32)
         * np.float32([1, 1, 0.3]))
    c[:, 2] -= 0.2
    verts = np.stack(
        [c, c + rng.uniform(0.01, 0.05, (extra, 3)).astype(np.float32),
         c + rng.uniform(0.01, 0.05, (extra, 3)).astype(np.float32)], axis=1)
    ds = prepare_scene(trt.add_triangles(
        base, verts, np.full((extra, 3), 0.6, np.float32),
        np.ones((extra,), np.float32)))
    return [ds.v0, ds.e1, ds.e2, ds.n, ds.rgb, ds.mat]


def shard(name: str):
    if name == "cornell":
        return [x[:26] for x in dense_shard(27)]
    if name == "dense_600":
        return dense_shard(600)
    # every row twice, then a stretch of them a third time: exact ties
    rows = dense_shard(300)
    return [torch.cat([x[:300], x[:300], x[40:140]]).contiguous()
            for x in rows]


def rays(n: int, seed: int):
    rng = np.random.RandomState(seed)
    start = rng.uniform(-0.8, 0.8, (n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return torch.from_numpy(start), torch.from_numpy(d)


@pytest.mark.parametrize("groups", [1, 2, partial.NEAR_GROUPS])
@pytest.mark.parametrize("name", ["cornell", "dense_600", "duplicated"])
def test_group_scan_is_the_plain_scan(name, groups):
    """The model's id and t are ``nearest_tris_plain``'s, and its u and v
    ``_tri_tuv``'s at the winning row, bit for bit, for every G."""
    tbl = shard(name)
    start, d = rays(400, seed=11)
    idx, t, u, v = group_scan(tbl[0], tbl[1], tbl[2], start, d, groups)
    t_p, _, _, _, _, idx_p = partial.nearest_tris_plain(*tbl, start, d)
    assert torch.equal(idx.to(torch.int32), idx_p)
    hit = idx >= 0
    assert hit.float().mean() > 0.5
    assert torch.equal(bits(t[hit]), bits(t_p[hit]))
    tt, uu, vv, _ = _tri_tuv(partial._shard(*tbl), start, d)
    k = idx.clamp(min=0)[:, None]
    assert torch.equal(bits(tt.gather(1, k)[:, 0][hit]), bits(t[hit]))
    assert torch.equal(bits(uu.gather(1, k)[:, 0][hit]), bits(u[hit]))
    assert torch.equal(bits(vv.gather(1, k)[:, 0][hit]), bits(v[hit]))
    if name == "duplicated":      # ties: the lowest of the equal rows won
        assert (idx[hit] < 300).all()


# --------------------------------------------------------------------------
# The launcher's grid
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_rays,blocks", [
    (65536, 2048),      # dense_8192 128x128 aa4: each batch, each tp=2 shard
    (8192, 256),        # the 600-row shard at 128x16 aa4
    (1 << 20, 32768),   # 512x512 aa4
    (262144, 8192),     # 256x256 aa4
    (4096, 128),        # the replay backward's 4,096-ray batch
    (33, 2),            # one ray past a block
    (32, 1),            # one block's rays
    (1, 1),             # one ray
])
def test_nearest_grid(n_rays, blocks):
    assert partial.nearest_grid(n_rays) == blocks
    # every ray has a thread in each of its groups, and no block is idle
    groups = partial.NEAR_GROUPS
    assert blocks * partial.THREADS >= n_rays * groups
    assert (blocks - 1) * partial.THREADS < n_rays * groups


def test_kernel_constants_are_the_wrappers():
    """The kernel's thread groups and row width (``kNearGroups``,
    ``kNearCols`` in csrc/partial.cu) are the wrapper's, which sizes the
    grid and packs the table by them."""
    src = (Path(partial.__file__).parent.parent / "csrc" / "partial.cu"
           ).read_text()
    consts = dict(re.findall(r"constexpr int (kNear\w+) = (\d+);", src))
    assert int(consts["kNearGroups"]) == partial.NEAR_GROUPS
    assert int(consts["kNearCols"]) == partial.NEAR_COLS
    assert partial.THREADS % (32 * partial.NEAR_GROUPS) == 0   # warp = group


# --------------------------------------------------------------------------
# On the card: the kernel at each G against the plain version
# --------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name,n_rays", [("cornell", 127), ("dense_600", 1500),
                                         ("duplicated", 2049)])
def test_k4_on_card(cuda_device, name, n_rays):
    tbl = [x.to(cuda_device) for x in shard(name)]
    start, d = (x.to(cuda_device) for x in rays(n_rays, seed=5))
    before = partial.NEAREST_LAUNCHES
    one = partial._nearest_launch(*tbl, start, d)
    two = partial._nearest_launch(*tbl, start, d)
    torch.cuda.synchronize()
    assert partial.NEAREST_LAUNCHES == before + 2
    assert partial.LAST_NEAREST_GRID == partial.nearest_grid(n_rays)
    for a, b in zip(one, two):                   # two runs: the same bits
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    ref = partial.nearest_tris_plain(*tbl, start, d)
    assert torch.equal(one[5], ref[5])
    hit = ref[5] >= 0
    assert torch.isinf(one[0][~hit]).all()
    assert (one[0][hit] - ref[0][hit]).abs().max() <= 1e-5
    assert (one[1] - ref[1]).abs().max() <= 1e-5
    for a, b in zip(one[2:5], ref[2:5]):
        assert torch.equal(a, b)
