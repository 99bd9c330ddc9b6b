"""The structure twin of the path-replay backward kernel (K7): the launch
wrapper and the plain version.

``bwd_twin`` is ONE launch of ``bwd_twin_kernel<n_pool>`` of
``csrc/bwd_twin.cu``, the Hopper counterpart of the TPU kernel
``uob_raytracer_tpu/flops.py:build_bwd_structure_twin`` (``make_kernel``):
the loop and memory structure of the port's backward kernel K2
(``csrc/render_bwd.cu``) driven by the same decision record, with the
adjoint arithmetic replaced by bwdmix calibration chains whose sizes
(``sizing``) ``flops.build_bwd_structure_twin`` solves for. It returns, as
K2's wrapper does, the per-block partial rows summed by ``torch.sum``: 16
columns per object (column 15 counts the object's visits) and 21 camera
columns, and the replayed image.

``bwd_twin_plain`` repeats the twin's arithmetic in torch over all rays at
once, operation by operation in float32, so every ray's values are the
kernel's; it sums the rows in float64 and also returns the sums of their
absolute values (the scale against which the kernel's float32 sums are
held) and the visit counts. For a CPU tensor the wrapper runs the plain
version; for a CUDA tensor it launches the kernel or raises. ``LAUNCHES``
counts the launches.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..config import RenderConfig
from ..ops.replay import Residuals
from ..scene import Scene
from . import _build
from .render_fwd import (CAM_COLS, GRAD_COLS, OBJ_COLS, SMEM_BUDGET_BYTES,
                         THREADS, _check)
from .peak import divide
from .render_bwd import REG_BOUNCES

HALF = 6          # iterations of each half of the main chain, at most
MAX_MAIN = 2 * HALF
MAX_SLOTS = 12    # accumulators of one main-chain iteration, at most
STEP_ACCS = 4     # the step chain's accumulators
STEP_DIV_SLOTS = (0, 3)   # those that divide (bwdmix at K = 4)
POOLS = (0, 32, 64, 96, 128)   # the pool sizes with a kernel instance
# The split instances (``bwd_twin_split_kernel<Var, MinBlocks>``, pool
# SPLIT_POOL only): K7 with one piece of K2's structure changed, timed
# beside K7 by ``chip_timing.py --split``; name: (launcher index, symbol).
SPLIT_POOL = 64
SPLITS = {
    "no_shuffles": (1, "bwd_twin_split_kernel<1, 1>"),
    "no_chain": (2, "bwd_twin_split_kernel<2, 1>"),
    "min_blocks_4": (3, "bwd_twin_split_kernel<0, 4>"),
    "min_blocks_5": (4, "bwd_twin_split_kernel<0, 5>"),
}

# Kernel launches since import.
LAUNCHES = 0

_F = np.float32


def symbol(n_pool: int) -> str:
    """The instance's name as ``flops.sass_census`` and
    ``flops.kernel_resources`` take it."""
    return f"bwd_twin_kernel<{n_pool}>"


def twin_table(scene: Scene, cfg: RenderConfig):
    """The twin's unified object table [n_obj, 17] on the scene's device:
    calibration values spread over [0.1, 0.9] (the JAX twin's table), and
    in column 15 each object's material code, which decides, as in K2,
    whether a ray's chain goes on. CPU-ref ignores the spheres, as the
    kernels do."""
    mats = [scene.tri_mat] + ([] if cfg.cpu_ref else [scene.sph_mat])
    mat = torch.cat(mats).detach().to(torch.float32)
    n_obj = mat.shape[0]
    tab = torch.from_numpy(np.linspace(0.1, 0.9, n_obj * OBJ_COLS,
                                       dtype=np.float32).reshape(n_obj, OBJ_COLS))
    tab = tab.to(mat.device)
    tab[:, 15] = mat
    return tab.contiguous()


def _halves(sizing: dict):
    """(first-half slots, second-half slots, first-half div sets,
    second-half div sets) of a sizing."""
    n_half = sizing["n_main"] // 2
    slots, divs = list(sizing["slots"]), [set(d) for d in sizing["divs"]]
    return slots[:n_half], slots[n_half:], divs[:n_half], divs[n_half:]


def check_sizing(sizing: dict) -> None:
    """Raise unless the sizing fits the kernel's caps and instances."""
    s1, s2, _, _ = _halves(sizing)
    if (len(sizing["slots"]) != sizing["n_main"] or len(s1) > HALF
            or len(s2) > HALF or sizing["n_pool"] not in POOLS
            or sizing["n_step"] < 0
            or any(not 0 <= s <= MAX_SLOTS for s in sizing["slots"])):
        raise ValueError(f"bwd_twin: sizing {sizing} outside the kernel's "
                         f"caps: n_main <= {MAX_MAIN}, slots <= {MAX_SLOTS}, "
                         f"n_pool in {POOLS}")


# --------------------------------------------------------------------------
# The plain torch version
# --------------------------------------------------------------------------

def twin_iter(a, x, use_div: bool):
    """One bwdmix body (``flops.py:_iter_ops``): 17 dependent operations,
    the last a divide or a subtract. Returns (result, s2): s2 is the middle
    value the pool may keep."""
    h = _F(0.5)
    t1 = a * x
    m1 = t1 < x
    w1 = torch.where(m1, t1, a)
    t2 = w1 * h
    s1 = t2 + x
    w2 = torch.where(m1, s1, t2)
    n1 = -w2
    w3 = torch.where(m1, n1, s1)
    s2 = w3 + t1
    w4 = torch.where(m1, s2, w3)
    t3 = w4 * x
    w5 = torch.where(m1, t3, w4)
    s3 = w5 + t2
    w6 = torch.where(m1, s3, w5)
    t4 = w6 * h
    sl = divide(s3, t4 + _F(1.125)) if use_div else s3 - t4
    return torch.where(m1, sl, a), s2


def tree_sum(vals):
    """The kernel's TreeSum: pairs level by level, an odd last one carried."""
    while len(vals) > 1:
        nxt = [vals[2 * i] + vals[2 * i + 1] for i in range(len(vals) // 2)]
        if len(vals) % 2:
            nxt.append(vals[-1])
        vals = nxt
    return vals[0]


def bwd_twin_plain(table, g, res: Residuals, cfg: RenderConfig,
                   sizing: dict) -> dict:
    """The plain torch version of ``bwd_twin``, on the tensors' device.
    Returns {"sums": float64 [n_obj*16 + 21], "abs_sums": the same of
    |row| terms, "img": [rows, W, 3] float32, "visits": int64 [n_obj]}."""
    check_sizing(sizing)
    n_obj = table.shape[0]
    A, B = cfg.aa_rays, cfg.bounces
    rows, W = g.shape[0], g.shape[1]
    n_pix = rows * W
    dev = g.device
    pid = res.prim_id.reshape(A, n_pix)
    lit = res.lit_cnt.reshape(A, n_pix)
    bid = res.bounce_id.reshape(B, A, n_pix) if B else None
    gx = g.reshape(n_pix, 3)[:, 0]
    miss = torch.zeros((1, OBJ_COLS), dtype=torch.float32, device=dev)
    miss[0, 15] = 1.0
    tab = torch.cat([table, miss])

    def row_of(ids):            # [17, n]; id -1 reads the miss row
        return tab[torch.where(ids >= 0, ids, n_obj).long()].T

    sums = torch.zeros(n_obj * GRAD_COLS + CAM_COLS, dtype=torch.float64,
                       device=dev)
    abs_sums = torch.zeros_like(sums)
    cols = torch.arange(GRAD_COLS, device=dev)

    def scatter(ids, gr):       # gr: 16 tensors [n]
        keep = ids >= 0
        idx = (ids[keep].long()[:, None] * GRAD_COLS + cols).reshape(-1)
        v = torch.stack(gr, dim=1)[keep].double().reshape(-1)
        sums.index_add_(0, idx, v)
        abs_sums.index_add_(0, idx, v.abs())

    s1, s2, d1, d2 = _halves(sizing)
    n_pool, n_step = sizing["n_pool"], sizing["n_step"]
    c_acc = [_F(1.0 + 1e-6 * s) for s in range(MAX_SLOTS)]
    c_step = [_F(1.0 + 1e-7 * s) for s in range(STEP_ACCS)]
    dcam = [torch.zeros(n_pix, dtype=torch.float32, device=dev)
            for _ in range(CAM_COLS)]
    img_acc = [torch.zeros(n_pix, dtype=torch.float32, device=dev)
               for _ in range(3)]
    for a in range(A):
        id0 = pid[a]
        xs = list(row_of(id0))
        chain = (id0 >= 0) & (xs[15] <= 0.0)
        xs[0] = (xs[0] + lit[a] * _F(1e-6)) + gx * _F(1e-3)
        accs = [xs[0]] + [xs[0] * c_acc[s] for s in range(1, MAX_SLOTS)]

        # first half; the pool keeps its snapshots
        pool = []
        for it in range(HALF):
            x = xs[it % OBJ_COLS]
            for s in range(MAX_SLOTS):
                mid = accs[s]
                if it < len(s1) and s < s1[it]:
                    accs[s], mid = twin_iter(accs[s], x, s in d1[it])
                j = 2 * (it * MAX_SLOTS + s)
                pool += [accs[s], mid][:max(0, n_pool - j)]
        a_mid = accs[0]

        # forward sweep over the steps the record says each ray ran
        carr, active = a_mid, chain
        n_exec = torch.zeros(n_pix, dtype=torch.int32, device=dev)
        saved = []
        for k in range(B):
            idk = torch.where(active, bid[k, a], -1)
            row = row_of(idk)
            saved.append((list(row[:11]) + [carr], idk))
            n_exec = n_exec + active.int()
            carr = torch.where(active, carr + row[0], carr)
            active = active & (idk >= 0) & (row[15] <= 0.0)

        # reverse sweep
        dcarr = carr
        for k in reversed(range(B)):
            on = k < n_exec
            if not bool(on.any()):
                continue
            sv, idk = saved[k]
            x = row_of(idk)[0]
            y = dcarr + sv[11]
            sa = [y * c_step[s] for s in range(STEP_ACCS)]
            for _ in range(n_step):
                sa = [twin_iter(sa[s], x, s in STEP_DIV_SLOTS)[0]
                      for s in range(STEP_ACCS)]
            gr = ([sa[c & 3] * sv[c] for c in range(12)]
                  + [sa[c & 3] for c in range(12, 15)]
                  + [torch.ones_like(y)])
            scatter(torch.where(on, idk, -1), gr)
            dcarr = torch.where(on, sa[0], dcarr)

        # second half, the primary site, the camera, the image
        accs[0] = dcarr + a_mid
        for i2 in range(HALF):
            x = xs[(HALF + i2) % OBJ_COLS]
            for s in range(MAX_SLOTS):
                if i2 < len(s2) and s < s2[i2]:
                    accs[s] = twin_iter(accs[s], x, s in d2[i2])[0]
        scatter(id0, [accs[c % MAX_SLOTS] for c in range(15)]
                + [torch.ones_like(a_mid)])
        for c in range(CAM_COLS):
            dcam[c] = dcam[c] + (accs[c % MAX_SLOTS] + a_mid)
        pacc = accs[0]
        if n_pool:
            pacc = pacc + tree_sum(pool)
        pe = pacc * _F(1e-6)
        for c in range(3):
            img_acc[c] = img_acc[c] + (accs[c] + pe)

    base = n_obj * GRAD_COLS
    for c in range(CAM_COLS):
        sums[base + c] = dcam[c].double().sum()
        abs_sums[base + c] = dcam[c].double().abs().sum()
    img = torch.stack([v / _F(A) for v in img_acc], dim=1).reshape(rows, W, 3)
    visits = sums[:base].reshape(n_obj, GRAD_COLS)[:, 15].round().long()
    return {"sums": sums, "abs_sums": abs_sums, "img": img, "visits": visits}


# --------------------------------------------------------------------------
# The wrapper
# --------------------------------------------------------------------------

def _sizing_ints(sizing: dict):
    """The launcher's sizing array: n_half, n_second, n_step, then slots and
    div bit masks, the first half's iterations at 0.., the second's at
    HALF.."""
    s1, s2, d1, d2 = _halves(sizing)
    slots, divs = [0] * MAX_MAIN, [0] * MAX_MAIN
    for base, ss, dd in ((0, s1, d1), (HALF, s2, d2)):
        for i, (s, d) in enumerate(zip(ss, dd)):
            slots[base + i] = s
            divs[base + i] = sum(1 << b for b in d)
    ints = [len(s1), len(s2), sizing["n_step"]] + slots + divs
    return (ctypes.c_int * len(ints))(*ints)


def bwd_twin(table, g, res: Residuals, cfg: RenderConfig, sizing: dict,
             _split: str | None = None):
    """One run of the twin on a whole frame's record: returns (sums
    [n_obj*16 + 21] float32, img [H, W, 3]). ``table`` is ``twin_table``'s,
    ``g`` an image cotangent [H, W, 3], ``res`` the record of
    ``render_fused_res``. A CUDA tensor launches ``bwd_twin_kernel``; a CPU
    tensor runs ``bwd_twin_plain``. ``_split`` (a key of ``SPLITS``, pool
    SPLIT_POOL, CUDA only) launches that split instance instead: an
    instrument whose sums are not the plain version's, and no launch of
    K7 (``LAUNCHES`` does not move)."""
    global LAUNCHES
    check_sizing(sizing)
    split = 0
    if _split is not None:
        if g.device.type != "cuda" or sizing["n_pool"] != SPLIT_POOL:
            raise ValueError(f"bwd_twin: split {_split!r} runs on a CUDA "
                             f"tensor with pool {SPLIT_POOL}")
        split = SPLITS[_split][0]
    if g.device.type == "cpu":
        out = bwd_twin_plain(table, g, res, cfg, sizing)
        return out["sums"].float(), out["img"]
    n_obj = table.shape[0]
    A, B, H, W = cfg.aa_rays, cfg.bounces, cfg.height, cfg.width
    if B > REG_BOUNCES:   # the twin mirrors K2's register instance
        raise ValueError(f"bwd_twin: {B} bounces; the kernel keeps at most "
                         f"{REG_BOUNCES} steps per ray")
    smem = 4 * (n_obj * OBJ_COLS + (THREADS // 32) * (n_obj * GRAD_COLS
                                                      + CAM_COLS))
    if smem > SMEM_BUDGET_BYTES:
        raise ValueError(f"bwd_twin: {n_obj} objects need {smem} B of shared "
                         f"memory (limit {SMEM_BUDGET_BYTES})")
    _check("twin table", table, (n_obj, OBJ_COLS))
    _check("g", g, (H, W, 3))
    _check("res.prim_id", res.prim_id, (A, H, W), torch.int32)
    _check("res.lit_cnt", res.lit_cnt, (A, H, W))
    if B:
        _check("res.bounce_id", res.bounce_id, (B, A, H, W), torch.int32)
    dev = g.device
    n_blocks = (H * W + THREADS - 1) // THREADS
    partial = torch.empty((n_blocks, n_obj * GRAD_COLS + CAM_COLS),
                          dtype=torch.float32, device=dev)
    img = torch.empty((H, W, 3), dtype=torch.float32, device=dev)
    dims = (ctypes.c_int * 5)(H, W, A, B, n_obj)
    fn = _build.load().bwd_twin_launch
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 7
                   + [ctypes.POINTER(ctypes.c_int)] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        err = fn(sizing["n_pool"], split, table.data_ptr(), g.data_ptr(),
                 res.prim_id.data_ptr(), res.lit_cnt.data_ptr(),
                 res.bounce_id.data_ptr() if B else 0, partial.data_ptr(),
                 img.data_ptr(), dims, _sizing_ints(sizing),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bwd_twin kernel launch failed: CUDA error {err}")
    LAUNCHES += split == 0
    return partial.sum(dim=0), img
