"""The structure twin of the path-replay backward kernel (K7): the launch
wrapper and the plain version.

``bwd_twin`` runs the twin of ``csrc/bwd_twin.cu``, the Hopper counterpart
of the TPU kernel ``uob_raytracer_tpu/flops.py:build_bwd_structure_twin``
(``make_kernel``): the loop and memory structure of the port's backward
kernel K2 (``csrc/render_bwd.cu``) driven by the same decision record,
with the adjoint arithmetic replaced by bwdmix calibration chains whose
sizes (``sizing``) ``flops.build_bwd_structure_twin`` solves for. It takes
K2's launches by K2's own rule (``render_bwd.splits``): on a split frame
``bwd_twin_free_kernel`` (K7f, K2f's twin: one thread per pixel, no chain,
on K2f's grid of tile ranges, ``render_bwd.free_grid``) over the pixels
none of whose rays bounces, listing the others per tile as K2f lists
them, then one ``torch.cumsum`` of its counts on the device and
``bwd_twin_chain_kernel``
(K7c, K2c's twin: one thread per AA ray) over the listed pixels;
otherwise the chain twin alone over every pixel. It returns, as K2's
wrapper does, the per-block partial rows of both launches summed by
``torch.sum``: 16 columns per object (column 15 counts the object's
visits) and 21 camera columns, and the replayed image.

``bwd_twin_plain`` repeats the twin's arithmetic in torch over all rays at
once, operation by operation in float32, so every ray's values are the
kernels'; each pixel takes the sizing of the launch that runs it, and
its rays go in ray order. It sums the rows in float64 and also returns
the sums of their absolute values (the scale against which the kernels'
float32 sums are held) and the visit counts, in all and per launch. For
a CPU tensor the wrapper runs the plain version; for a CUDA tensor it
launches the kernels or raises. ``FREE_LAUNCHES`` counts the free twin's
launches, ``LAUNCHES`` the chain twin's.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..config import RenderConfig
from ..ops.replay import Residuals
from ..scene import Scene
from . import _build, render_bwd
from .render_fwd import (CAM_COLS, GRAD_COLS, OBJ_COLS, SMEM_BUDGET_BYTES,
                         THREADS, _check, pack_scene, pixels_per_block)
from .peak import divide

HALF = 6          # iterations of each half of the main chain, at most
MAX_MAIN = 2 * HALF
MAX_SLOTS = 12    # accumulators of one main-chain iteration, at most
STEP_ACCS = 4     # the step chain's accumulators
STEP_DIV_SLOTS = (0, 3)   # those that divide (bwdmix at K = 4)
# The pool sizes with a kernel instance: the chain twin's (K2c's 168
# registers) and the free twin's (K2f's 128).
POOLS = (0, 32, 64, 96, 128)
FREE_POOLS = (0, 16, 32, 48, 64)
# The split instances (``bwd_twin_split_kernel<Var, MinBlocks>``, pool
# SPLIT_POOL only): the chain twin with one piece of K2c's structure
# changed, timed beside it by ``chip_timing.py --split k2k5``; name:
# (launcher index, symbol).
SPLIT_POOL = 64
SPLITS = {
    "no_shuffles": (1, "bwd_twin_split_kernel<1, 3>"),
    "no_chain": (2, "bwd_twin_split_kernel<2, 3>"),
    "no_search": (3, "bwd_twin_split_kernel<3, 3>"),
    "min_blocks_4": (4, "bwd_twin_split_kernel<0, 4>"),
}

# Kernel launches since import: the chain twin's, the free twin's.
LAUNCHES = 0
FREE_LAUNCHES = 0

_F = np.float32


def symbol(n_pool: int, kind: str = "chain") -> str:
    """The instance's name (``kind`` "chain" or "free") as
    ``flops.sass_census`` and ``flops.kernel_resources`` take it."""
    return f"bwd_twin_{kind}_kernel<{n_pool}>"


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


def camera_row(table):
    """The twin's camera row [21]: the table's first 21 values (cyclically
    where it holds fewer), which the kernels stage apart as K2 stages its
    camera row."""
    flat = table.reshape(-1)
    return flat[torch.arange(CAM_COLS, device=flat.device) % flat.numel()]


def chain_pixels(table, res: Residuals, cfg: RenderConfig):
    """bool [rows * W]: the pixels K2's chain-free launch leaves to the
    chain launch, by its rule: a ray of the pixel hit an object whose
    material code (column 15) is <= 0, in a config that bounces."""
    A = cfg.aa_rays
    pid = res.prim_id.reshape(A, -1)
    if not cfg.bounces:
        return torch.zeros(pid.shape[1], dtype=torch.bool, device=pid.device)
    mat = table[:, 15]
    ray = (pid >= 0) & (mat[pid.clamp(min=0).long()] <= 0.0)
    return ray.any(dim=0)


def launch_grids(n_pix: int, aa_rays: int, split: bool, slots: int = 0):
    """(the free twin's grid or None, the chain twin's blocks) over n_pix
    pixels, as the launchers take them: K2's grids. The free launch's is
    K2f's grid of tile ranges on a device that holds ``slots`` of K2f's
    blocks at once (``render_bwd.free_grid``: (blocks, tiles a block));
    the chain launch takes one block a tile with the list (its blocks walk
    the listed pixels' chunks), else one block a chunk of
    ``pixels_per_block(aa_rays)`` (``render_bwd.chain_blocks``)."""
    if split and slots < 1:
        raise ValueError(f"bwd_twin: the free twin's grid needs the device's "
                         f"slots for K2f's blocks (got {slots})")
    free = render_bwd.free_grid(n_pix, slots) if split else None
    return free, render_bwd.chain_blocks(n_pix, aa_rays, split)


def listed(lists, counts):
    """The pixels a free launch listed, in order: each tile's first
    counts[t] entries of lists[t * 128 ...] (int32 [sum(counts)])."""
    tiles = counts.shape[0]
    keep = (torch.arange(THREADS, device=counts.device)[None, :]
            < counts[:, None])
    return lists[:tiles * THREADS].reshape(tiles, THREADS)[keep].contiguous()


def _halves(sizing: dict):
    """(first-half slots, second-half slots, first-half div sets,
    second-half div sets) of a sizing."""
    n_half = sizing["n_main"] // 2
    slots, divs = list(sizing["slots"]), [set(d) for d in sizing["divs"]]
    return slots[:n_half], slots[n_half:], divs[:n_half], divs[n_half:]


def check_sizing(sizing: dict, pools=POOLS) -> None:
    """Raise unless the sizing fits the kernels' caps and one of ``pools``
    (the chain twin's instances; ``FREE_POOLS`` for the free twin's)."""
    s1, s2, _, _ = _halves(sizing)
    if (len(sizing["slots"]) != sizing["n_main"] or len(s1) > HALF
            or len(s2) > HALF or sizing["n_pool"] not in pools
            or sizing["n_step"] < 0
            or any(not 0 <= s <= MAX_SLOTS for s in sizing["slots"])):
        raise ValueError(f"bwd_twin: sizing {sizing} outside the kernel's "
                         f"caps: n_main <= {MAX_MAIN}, slots <= {MAX_SLOTS}, "
                         f"n_pool in {pools}")


def _launches(table, cfg: RenderConfig, rows: int, sizing: dict,
              free_sizing: dict | None):
    """(split, the free twin's sizing or None): K2's rule for the frame,
    each sizing checked against its instances."""
    split = render_bwd.splits(cfg, rows, table.shape[0])
    check_sizing(sizing)
    if not split:
        return False, None
    free_sizing = sizing if free_sizing is None else free_sizing
    check_sizing(free_sizing, FREE_POOLS)
    return True, free_sizing


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


def _ray(row_of, cam, pid_a, lit_a, gx, bid_a, sizing: dict, n_bounces: int):
    """One AA ray of every pixel given (twin_ray.cuh): its reverse steps
    [(k, on, id, 16 columns)], its primary site (id, 16 columns), its
    camera terms [21] and its image terms [3]."""
    s1, s2, d1, d2 = _halves(sizing)
    n_pool, n_step = sizing["n_pool"], sizing["n_step"]
    id0 = pid_a
    xs = list(row_of(id0))
    chain = (id0 >= 0) & (xs[15] <= 0.0)
    xs[0] = (xs[0] + lit_a * _F(1e-6)) + gx * _F(1e-3)
    accs = [xs[0]] + [xs[0] * _F(1.0 + 1e-6 * s) for s in range(1, MAX_SLOTS)]

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
    n_exec = torch.zeros_like(id0)
    saved = []
    for k in range(n_bounces):
        idk = torch.where(active, bid_a[k], -1)
        row = row_of(idk)
        saved.append((list(row[:11]) + [carr], idk))
        n_exec = n_exec + active.int()
        carr = torch.where(active, carr + row[0], carr)
        active = active & (idk >= 0) & (row[15] <= 0.0)

    # reverse sweep
    steps, dcarr = [], carr
    for k in reversed(range(n_bounces)):
        on = k < n_exec
        if not bool(on.any()):
            continue
        sv, idk = saved[k]
        x = row_of(idk)[0]
        y = dcarr + sv[11]
        sa = [y * _F(1.0 + 1e-7 * s) for s in range(STEP_ACCS)]
        for _ in range(n_step):
            sa = [twin_iter(sa[s], x, s in STEP_DIV_SLOTS)[0]
                  for s in range(STEP_ACCS)]
        steps.append((k, on, idk, [sa[c & 3] * sv[c] for c in range(12)]
                      + [sa[c & 3] for c in range(12, 15)]
                      + [torch.ones_like(y)]))
        dcarr = torch.where(on, sa[0], dcarr)

    # second half, the primary site, the camera, the image terms
    accs[0] = dcarr + a_mid
    for i2 in range(HALF):
        x = xs[(HALF + i2) % OBJ_COLS]
        for s in range(MAX_SLOTS):
            if i2 < len(s2) and s < s2[i2]:
                accs[s] = twin_iter(accs[s], x, s in d2[i2])[0]
    prim = (id0, [accs[c % MAX_SLOTS] for c in range(15)]
            + [torch.ones_like(a_mid)])
    cam_terms = [accs[c % MAX_SLOTS] + cam[c] for c in range(CAM_COLS)]
    pacc = accs[0]
    if n_pool:
        pacc = pacc + tree_sum(pool)
    pe = pacc * _F(1e-6)
    return steps, prim, cam_terms, [accs[c] + pe for c in range(3)]


def bwd_twin_plain(table, g, res: Residuals, cfg: RenderConfig,
                   sizing: dict, free_sizing: dict | None = None) -> dict:
    """The plain torch version of ``bwd_twin``, on the tensors' device:
    on a frame K2 splits (``render_bwd.splits``) the free pixels take
    ``free_sizing`` (default: ``sizing``) and the pixels of
    ``chain_pixels`` ``sizing``; otherwise every pixel takes ``sizing``.
    Every row is scattered in the one-launch order (per ray, its reverse
    steps from the deepest, then its primary site), so with both sizings
    equal the result is the one-launch plain version's bit for bit.
    Returns {"sums": float64 [n_obj*16 + 21], "abs_sums": the same of
    |row| terms, "img": [rows, W, 3] float32, "visits": int64 [n_obj],
    "split": bool, "chain_pixels": the chain twin's pixels (bool [rows *
    W]; None without the split), "launches": {"free" (split only),
    "chain": {"sums", "abs_sums", "visits"} of that launch's pixels}}."""
    rows, W = g.shape[0], g.shape[1]
    split, free_sizing = _launches(table, cfg, rows, sizing, free_sizing)
    n_obj = table.shape[0]
    A, B = cfg.aa_rays, cfg.bounces
    n_pix = rows * W
    dev = g.device
    pid = res.prim_id.reshape(A, n_pix)
    lit = res.lit_cnt.reshape(A, n_pix)
    bid = res.bounce_id.reshape(B, A, n_pix) if B else None
    gx = g.reshape(n_pix, 3)[:, 0]
    cam = camera_row(table)
    miss = torch.zeros((1, OBJ_COLS), dtype=torch.float32, device=dev)
    miss[0, 15] = 1.0
    tab = torch.cat([table, miss])

    def row_of(ids):            # [17, n]; id -1 reads the miss row
        return tab[torch.where(ids >= 0, ids, n_obj).long()].T

    # the launches: (name, their pixels' mask or None for all, sizing)
    if split:
        on_chain = chain_pixels(table, res, cfg)
        groups = [("free", ~on_chain, free_sizing), ("chain", on_chain, sizing)]
    else:
        groups = [("chain", None, sizing)]
    # the sums and their magnitudes: in all, and per launch where split
    sinks = [("all", None)] + ([(n, m) for n, m, _ in groups] if split
                               else [])
    n_sums = n_obj * GRAD_COLS + CAM_COLS
    totals = {name: [torch.zeros(n_sums, dtype=torch.float64, device=dev)
                     for _ in range(2)] for name, _ in sinks}
    cols = torch.arange(GRAD_COLS, device=dev)

    def scatter(ids, gr):       # gr: 16 tensors [n_pix]; ids -1: nothing
        for name, mask in sinks:
            keep = ids >= 0 if mask is None else (ids >= 0) & mask
            idx = (ids[keep].long()[:, None] * GRAD_COLS + cols).reshape(-1)
            v = torch.stack(gr, dim=1)[keep].double().reshape(-1)
            totals[name][0].index_add_(0, idx, v)
            totals[name][1].index_add_(0, idx, v.abs())

    def merged(parts, fill, dtype):   # one [n_pix] tensor from the groups'
        if len(parts) == 1 and parts[0][0] is None:
            return parts[0][1]
        out = torch.full((n_pix,), fill, dtype=dtype, device=dev)
        for mask, v in parts:
            out[mask] = v
        return out

    dcam = [torch.zeros(n_pix, dtype=torch.float32, device=dev)
            for _ in range(CAM_COLS)]
    img_acc = [torch.zeros(n_pix, dtype=torch.float32, device=dev)
               for _ in range(3)]
    for a in range(A):
        outs = []
        for _, mask, sz in groups:
            def sub(t, m=mask):
                return t if m is None else t[m]
            outs.append((mask, _ray(row_of, cam, sub(pid[a]), sub(lit[a]),
                                    sub(gx), [sub(bid[k, a]) for k in range(B)],
                                    sz, B)))
        # the reverse steps, from the deepest, as one launch scatters them
        for k in reversed(range(B)):
            hits = [(mask, st) for mask, (steps, _, _, _) in outs
                    for st in steps if st[0] == k]
            if not hits:
                continue
            ids = merged([(m, torch.where(st[1], st[2], -1)) for m, st in hits],
                         -1, torch.int32)
            scatter(ids, [merged([(m, st[3][c]) for m, st in hits], 0.0,
                                 torch.float32) for c in range(GRAD_COLS)])
        scatter(merged([(m, o[1][0]) for m, o in outs], -1, torch.int32),
                [merged([(m, o[1][1][c]) for m, o in outs], 0.0,
                        torch.float32) for c in range(GRAD_COLS)])
        for c in range(CAM_COLS):
            dcam[c] = dcam[c] + merged([(m, o[2][c]) for m, o in outs], 0.0,
                                       torch.float32)
        for c in range(3):
            img_acc[c] = img_acc[c] + merged([(m, o[3][c]) for m, o in outs],
                                             0.0, torch.float32)

    base = n_obj * GRAD_COLS
    for name, mask in sinks:
        sums, abs_sums = totals[name]
        for c in range(CAM_COLS):
            v = dcam[c] if mask is None else dcam[c][mask]
            sums[base + c] = v.double().sum()
            abs_sums[base + c] = v.double().abs().sum()

    def visits(sums):
        return sums[:base].reshape(n_obj, GRAD_COLS)[:, 15].round().long()

    sums, abs_sums = totals["all"]
    img = torch.stack([v / _F(A) for v in img_acc], dim=1).reshape(rows, W, 3)
    launches = {name: {"sums": totals[name if split else "all"][0],
                       "abs_sums": totals[name if split else "all"][1],
                       "visits": visits(totals[name if split else "all"][0])}
                for name, _, _ in groups}
    return {"sums": sums, "abs_sums": abs_sums, "img": img,
            "visits": visits(sums), "split": split,
            "chain_pixels": on_chain if split else None,
            "launches": launches}


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


_INTS = ctypes.POINTER(ctypes.c_int)


def _declare(lib: ctypes.CDLL):
    """The two launchers: "free" (pool, table, g, pid, lit, the partials,
    the image, list, counts, dims, sizing, blocks, tiles a block, stream)
    and "chain" (pool,
    split, table, g, pid, lit, bid, the partials, the image, list,
    offsets, pixels, dims, sizing, stream)."""
    free, chain = lib.bwd_twin_free_launch, lib.bwd_twin_chain_launch
    free.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8 + [_INTS] * 2
                     + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    chain.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 10 + [_INTS] * 2
                      + [ctypes.c_void_p])
    free.restype = chain.restype = ctypes.c_int
    return {"free": free, "chain": chain}


def bwd_twin(table, g, res: Residuals, cfg: RenderConfig, sizing: dict,
             free_sizing: dict | None = None, parts: bool = False,
             _split: str | None = None):
    """One run of the twin on a whole frame's record: returns (sums
    [n_obj*16 + 21] float32, img [H, W, 3]). ``table`` is ``twin_table``'s,
    ``g`` an image cotangent [H, W, 3], ``res`` the record of
    ``render_fused_res``. On a frame K2 splits (``render_bwd.splits``) the
    free twin runs with ``free_sizing`` (default: ``sizing``), then the
    chain twin with ``sizing`` over the pixels the free twin listed;
    otherwise the chain twin alone runs every pixel. With ``parts`` it
    returns ({"free" (split only), "chain": each launch's sums; "list"
    (split only): the free launch's listed pixels in order; "grid" (split
    only, CUDA only): the free launch's (blocks, tiles a block)}, img). The
    free twin runs on K2f's grid (``launch_grids`` with
    ``render_bwd.free_slots``), so its partial rows, one a block, and the
    order of its sums follow K2f's. A CUDA
    tensor launches the kernels; a CPU tensor runs ``bwd_twin_plain``.
    ``_split`` (a key of ``SPLITS``, pool SPLIT_POOL, CUDA only; "no_search"
    on a split frame) launches that split instance in place of the chain
    twin: an instrument whose sums are not the plain version's, and no
    launch of K7c (``LAUNCHES`` does not move)."""
    global LAUNCHES, FREE_LAUNCHES
    H, W = g.shape[0], g.shape[1]
    split, free_sizing = _launches(table, cfg, H, sizing, free_sizing)
    which = 0
    if _split is not None:
        if (g.device.type != "cuda" or sizing["n_pool"] != SPLIT_POOL
                or (_split == "no_search" and not split)):
            raise ValueError(f"bwd_twin: split {_split!r} runs on a CUDA "
                             f"tensor with pool {SPLIT_POOL} (no_search: on "
                             f"a frame K2 splits)")
        which = SPLITS[_split][0]
    if g.device.type == "cpu":
        out = bwd_twin_plain(table, g, res, cfg, sizing, free_sizing)
        if parts:
            got = {k: v["sums"].float() for k, v in out["launches"].items()}
            if split:
                got["list"] = torch.nonzero(chain_pixels(table, res, cfg))[
                    :, 0].int()
            return got, out["img"]
        return out["sums"].float(), out["img"]
    n_obj = table.shape[0]
    A, B = cfg.aa_rays, cfg.bounces
    if B > render_bwd.REG_BOUNCES:   # the twin mirrors K2's register instance
        raise ValueError(f"bwd_twin: {B} bounces; the kernel keeps at most "
                         f"{render_bwd.REG_BOUNCES} steps per ray")
    smem = 4 * (n_obj * OBJ_COLS + CAM_COLS + (THREADS // 32) * (
        n_obj * GRAD_COLS + CAM_COLS) + pixels_per_block(A) * (3 * A + 1))
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
    cols = n_obj * GRAD_COLS + CAM_COLS
    n_tiles = -(-H * W // THREADS)
    grid, n_chain = launch_grids(
        H * W, A, split, render_bwd.free_slots(dev, n_obj) if split else 0)
    partial = torch.empty((n_chain, cols), dtype=torch.float32, device=dev)
    img = torch.empty((H, W, 3), dtype=torch.float32, device=dev)
    dims = (ctypes.c_int * 5)(H, W, A, B, n_obj)
    launch = _declare(_build.load())
    lists = off = pixels = None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        record = (table.data_ptr(), g.data_ptr(), res.prim_id.data_ptr(),
                  res.lit_cnt.data_ptr())
        if split:
            # one partial row a block of the grid; a list and a count a tile
            partial_free = torch.empty((grid[0], cols), dtype=torch.float32,
                                       device=dev)
            lists = torch.empty((n_tiles * THREADS,), dtype=torch.int32,
                                device=dev)
            counts = torch.empty((n_tiles,), dtype=torch.int32, device=dev)
            err = launch["free"](free_sizing["n_pool"], *record,
                                 partial_free.data_ptr(), img.data_ptr(),
                                 lists.data_ptr(), counts.data_ptr(), dims,
                                 _sizing_ints(free_sizing), *grid, stream)
            if err != 0:
                raise RuntimeError(f"bwd_twin free kernel launch failed: "
                                   f"CUDA error {err}")
            FREE_LAUNCHES += 1
            off = torch.cumsum(counts, 0, dtype=torch.int32)
            if _split == "no_search":
                pixels = listed(lists, counts)
        err = launch["chain"](
            sizing["n_pool"], which, *record,
            res.bounce_id.data_ptr() if B else 0, partial.data_ptr(),
            img.data_ptr(), 0 if lists is None else lists.data_ptr(),
            0 if off is None else off.data_ptr(),
            0 if pixels is None else pixels.data_ptr(), dims,
            _sizing_ints(sizing), stream)
    if err != 0:
        raise RuntimeError(f"bwd_twin chain kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += which == 0
    sums_chain = partial.sum(dim=0)
    if not split:
        return ({"chain": sums_chain}, img) if parts else (sums_chain, img)
    sums_free = partial_free.sum(dim=0)
    if parts:
        return {"free": sums_free, "chain": sums_chain,
                "list": listed(lists, counts), "grid": grid}, img
    return sums_free + sums_chain, img


def blocks_per_sm(kind: str, n_pool: int, cfg: RenderConfig, n_obj: int) -> int:
    """How many blocks of the ``kind`` twin ("free" or "chain") of pool
    ``n_pool`` one SM of the current CUDA device holds at ``cfg`` (the
    runtime's occupancy count; the free twin's at ``FREE_MAX_TILES`` tiles a
    block, as ``render_bwd.free_blocks_per_sm`` counts K2f's): an
    instrument, beside ``render_bwd.chain_blocks_per_sm``."""
    dims = (ctypes.c_int * 5)(cfg.height, cfg.width, cfg.aa_rays, cfg.bounces,
                              n_obj)
    fn = _build.load().bwd_twin_blocks_per_sm
    fn.argtypes = [ctypes.c_int, ctypes.c_int, _INTS, _INTS]
    fn.restype = ctypes.c_int
    out = ctypes.c_int(0)
    err = fn(0 if kind == "free" else 1, n_pool, dims, ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"bwd_twin_blocks_per_sm: CUDA error {err}")
    return out.value


def k2_free_list(scene: Scene, cfg: RenderConfig, res: Residuals):
    """The pixels K2's chain-free launch lists on this record, in order
    (``listed`` of its list and counts): one launch of
    ``render_bwd_free_kernel`` through ``render_bwd``'s launcher with a
    zero cotangent, for holding the free twin's list to it. A comparison,
    so ``render_bwd.FREE_LAUNCHES`` does not move; CUDA only."""
    n_tri = scene.num_triangles
    n_sph = 0 if cfg.cpu_ref else scene.num_spheres
    H, W = cfg.height, cfg.width
    dev = scene.device
    tri, sph, cam = (t.detach().contiguous() for t in pack_scene(scene))
    g = torch.zeros((H, W, 3), dtype=torch.float32, device=dev)
    n_tiles = -(-H * W // THREADS)
    blocks, per_block = render_bwd.free_grid(
        H * W, render_bwd.free_slots(dev, n_tri + n_sph))
    partial = torch.empty((blocks, (n_tri + n_sph) * GRAD_COLS + CAM_COLS),
                          dtype=torch.float32, device=dev)
    lists = torch.empty((n_tiles * THREADS,), dtype=torch.int32, device=dev)
    counts = torch.empty((n_tiles,), dtype=torch.int32, device=dev)
    ints, floats = render_bwd.launch_params(cfg, 0, H, n_tri, n_sph, False)
    fn = render_bwd._declare(_build.load(), False)["free"]
    with torch.cuda.device(dev):
        err = fn(tri.data_ptr(), sph.data_ptr(), cam.data_ptr(), g.data_ptr(),
                 res.prim_id.data_ptr(), res.lit_cnt.data_ptr(),
                 partial.data_ptr(), 0, lists.data_ptr(), counts.data_ptr(),
                 ints, floats, blocks, per_block,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"render_bwd_free_kernel launch failed: CUDA error "
                           f"{err}")
    return listed(lists, counts)
