"""The FP32 peak calibration chains (K6) and the census probe: wrappers and
plain versions.

``peak_chain(mode, k, x)`` is ONE launch of ``peak_chain<mode, k>`` of
``csrc/peak.cu``, the Hopper counterpart of the TPU kernel
``uob_raytracer_tpu/flops.py:measure_vpu_peak`` (``make_kernel``): per
element of x, k independent accumulators run ``INNER`` iterations of the
mode's body and are summed. ``flops.measure_fp32_peak`` times it.
``census_probe(x)`` is one launch of ``census_probe_kernel``, the
counterpart of the JAX test fixture ``tests/test_flops.py:_tiny_pallas``
(five multiplies, then three adds), whose SASS ``flops.sass_census``
counts; ``floor_launch(x)`` launches a kernel that does nothing on the
probe's grid (with ``copy``, only the probe's load and store): the launch
floor its time is held against.

The plain torch versions (``peak_chain_plain``, ``census_probe_plain``)
repeat the arithmetic operation by operation in float32, in the kernel's
order; ``fma`` is computed in float64 and rounded once, divides and square
roots through float64 (``divide``, ``sqrt``), so that they round as the
kernel's IEEE ones do. For a tensor on the CPU the wrappers run those; for
a CUDA tensor they launch the kernel or raise. ``LAUNCHES``,
``PROBE_LAUNCHES`` and ``FLOOR_LAUNCHES`` count the launches.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from .render_fwd import _check

MODES = ("fma", "add", "mix", "bwdmix")
KS = (1, 2, 4, 8, 16, 32)        # the accumulator counts with an instance
INNER = 500                      # iterations of the chain (kInner)
# iterations one trip of the kernel's loop runs, by K (kUnroll<K>)
UNROLL = {1: 20, 2: 20, 4: 10, 8: 4, 16: 2, 32: 1}
MIX_OPS_PER_ITER = 17            # source operations of one mix / bwdmix body
THREADS = 128

# Kernel launches since import: the chains, the census probe, the launch
# floor.
LAUNCHES = 0
PROBE_LAUNCHES = 0
FLOOR_LAUNCHES = 0

_F = np.float32
_BWD_DIV_SLOTS = (0, 3, 6, 9, 12)   # accumulators (mod 16) whose slot divides


def symbol(mode: str, k: int) -> str:
    """The instance's name as ``flops.sass_census`` takes it."""
    return f"peak_chain<{MODES.index(mode)}, {k}>"


def ops_per_iter(mode: str) -> int:
    """Source operations of one accumulator's body (FMA counts 1)."""
    return MIX_OPS_PER_ITER if mode in ("mix", "bwdmix") else 1


# --------------------------------------------------------------------------
# The plain torch versions
# --------------------------------------------------------------------------

def divide(a, b):
    """a / b in float32, correctly rounded on any device: through float64,
    where the rounding twice is exact (torch's own float32 division and
    square root need not round correctly; the kernels' do)."""
    return (a.double() / b.double()).float()


def sqrt(a):
    """The square root in float32, correctly rounded (see ``divide``)."""
    return torch.sqrt(a.double()).float()


def bwdmix_iter(acc, x):
    """One iteration of the bwdmix body on every accumulator: ``acc`` is
    [K, ...] (row k is accumulator k, whose slow-op slot is fixed by k % 16:
    a divide, abs + sqrt, or a subtract), ``x`` broadcasts against a row.
    The counterpart of ``uob_raytracer_tpu/flops.py:_bwdmix_iter``,
    operation by operation."""
    h = _F(0.5)
    t1 = acc * x
    m1 = t1 < x
    w1 = torch.where(m1, t1, acc)
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
    slot = torch.arange(acc.shape[0], device=acc.device) % 16
    slot = slot.reshape((-1,) + (1,) * (acc.dim() - 1))
    div = (slot[..., None] == torch.tensor(_BWD_DIV_SLOTS, device=acc.device)
           ).any(dim=-1)
    sl = torch.where(div, divide(s3, t4 + _F(1.125)),
                     torch.where(slot == 15, sqrt(torch.abs(t4)), s3 - t4))
    return torch.where(m1, sl, acc)


def mix_iter(acc, x):
    """One iteration of the mix body (``flops.py:503-523``) on every
    accumulator of ``acc``."""
    h = _F(0.5)
    t1 = acc * x
    t2 = t1 * x
    t3 = acc * h
    s1 = t1 + t2
    m1 = s1 >= t3
    m2 = t2 < acc
    m3 = m1 & m2
    d = t3 - t1
    n1 = -d
    w = torch.where(m3, n1, t2)
    t4 = w * x
    t5 = t4 * h
    s2 = w + t5
    m4 = s2 != x
    t6 = torch.maximum(s2, t4)
    return torch.where(m4, t6, acc) * _F(0.999)


def peak_chain_plain(mode: str, k: int, x):
    """The plain torch version of ``peak_chain``: the k accumulators as the
    rows of one [k, n] tensor, ``INNER`` iterations, then their sum in
    order (accumulator 0 first)."""
    if mode not in MODES:
        raise ValueError(f"peak_chain: mode {mode!r}, one of {MODES}")
    x = x.reshape(-1)
    c = torch.tensor([_F(1.0 + 1e-7 * i) for i in range(k)],
                     device=x.device)[:, None]
    acc = x[None] * c
    if mode == "fma":
        xd, bias = x.double()[None], float(_F(1e-7))
        for _ in range(INNER):
            acc = (acc.double() * xd + bias).float()
    else:
        step = {"add": lambda a: a + x, "mix": lambda a: mix_iter(a, x),
                "bwdmix": lambda a: bwdmix_iter(a, x)}[mode]
        for _ in range(INNER):
            acc = step(acc)
    out = acc[0]
    for i in range(1, k):
        out = out + acc[i]
    return out


def census_probe_plain(x):
    """y = x, then five y = y * x and three y = y + x."""
    y = x
    for _ in range(5):
        y = y * x
    for _ in range(3):
        y = y + x
    return y


# --------------------------------------------------------------------------
# The wrappers
# --------------------------------------------------------------------------

def _flat(name: str, x):
    x = x.reshape(-1)
    _check(name, x, (x.numel(),))
    return x


def peak_chain(mode: str, k: int, x):
    """Chain ``mode`` with ``k`` accumulators over every element of the
    float32 tensor x; returns the flat [x.numel()] sums. A CUDA tensor
    launches ``peak_chain<mode, k>``, a CPU tensor runs
    ``peak_chain_plain``."""
    global LAUNCHES
    if mode not in MODES or k not in KS:
        raise ValueError(f"peak_chain: mode {mode!r} in {MODES}, k {k} in "
                         f"{KS}")
    if x.device.type == "cpu":
        return peak_chain_plain(mode, k, x)
    x = _flat("peak_chain x", x)
    out = torch.empty_like(x)
    fn = _build.load().peak_chain_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        err = fn(MODES.index(mode), k, x.data_ptr(), out.data_ptr(),
                 x.numel(), torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"peak_chain kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    return out


def census_probe(x):
    """The census probe over every element of the float32 tensor x (flat
    result). A CUDA tensor launches ``census_probe_kernel``, a CPU tensor
    runs ``census_probe_plain``."""
    global PROBE_LAUNCHES
    if x.device.type == "cpu":
        return census_probe_plain(x.reshape(-1))
    x = _flat("census_probe x", x)
    out = torch.empty_like(x)
    fn = _build.load().census_probe_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), out.data_ptr(), x.numel(),
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"census_probe kernel launch failed: CUDA error "
                           f"{err}")
    PROBE_LAUNCHES += 1
    return out


def floor_launch(x, copy: bool = False):
    """One launch of ``floor_kernel`` on the grid ``census_probe`` takes
    for x: no work, or with ``copy`` only the probe's load and store
    (returns the flat copy). The floor of a launch on this card; its plain
    version, for a CPU tensor, does nothing (or copies)."""
    global FLOOR_LAUNCHES
    if x.device.type == "cpu":
        return x.reshape(-1).clone() if copy else None
    x = _flat("floor_launch x", x)
    out = torch.empty_like(x)
    fn = _build.load().floor_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        err = fn(int(copy), x.data_ptr(), out.data_ptr(), x.numel(),
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"floor kernel launch failed: CUDA error {err}")
    FLOOR_LAUNCHES += 1
    return out if copy else None
