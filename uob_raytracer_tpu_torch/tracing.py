"""Spans and counters at the port's layer boundaries: where the host's time
goes in a training step or a frame, on the host's clock and on the
profiler's.

``span(name)`` marks a layer boundary (``rt.train_step``, ``rt.render``,
``rt.fwd.launch``, ``rt.bwd.segment_sum``, ...); ``count(name, n)`` adds to
a counter there (``bwd.bands``); ``gauge(name, parts)`` keeps device tensors
whose total is a size known only on the device (``bwd.chain_pixels``, the
pixels the chain launch of the last backward walked), read once at
``drain()``. Three states:

- Off (the default), and no profiler recording: a span checks two flags and
  returns one shared null context. It records nothing, allocates nothing
  and calls nothing in torch; ``count`` returns at once.
- A ``torch.profiler`` recording: each span also opens
  ``torch.profiler.record_function(name)``, so the program's spans appear
  in the profiler's trace as ``user_annotation`` events, on the clock of
  the device's kernels, copies and sets. (``record_function`` costs
  microseconds even with no profiler running: it is entered only while one
  records.)
- ``enable()``: each span leaves a ``Span`` record (name, id, parent id,
  step id, start and end in ``time.perf_counter_ns``, thread) and the
  counters count. ``drain()`` hands both over, and ``recorded()`` the
  spans of one block. ``enable(waits=True)`` also puts CUDA into the
  sync-debug mode "warn" and counts each host wait it reports under
  ``waits.<innermost open span>`` (``waits.outside`` with none open), with
  the file:line that waited, at the moment the warning is raised;
  ``disable()`` restores the mode and the warning filters.

A span opened with ``step=True`` (``rt.train_step``, ``rt.tick``) takes the
next step id, and every span opened inside it carries that id. A span
entered directly inside an open span of the same name on the same thread
adds nothing: the API's entry points call one another.

Parents are found on one stack of open spans for the process, not one per
thread: the autograd engine runs a CUDA scene's backward
(``render._FusedRender.backward``) on its own device thread while the
caller blocks in ``torch.autograd.grad``, so the backward's spans nest in
the caller's ``rt.train_step``. Spans that two threads hold open at once
without nesting in time would be parented wrongly; the port opens none.

A replayed CUDA graph runs no Python, so it counts nothing itself. The
block that captures it runs inside ``held()``, which keeps what the block
counted (its counters, its gauges and its kernels' launches) whether
recording is on or not, and each replay hands that to ``repeat()``: the
launches go to the kernels' launch counters, and while recording the
counters are added and the gauges set again. A gauge held at the capture
names the graph's own tensors, which every replay writes anew.

Spans never read a tensor, never synchronise and never change what the
program computes; a gauge is read on the host only by ``drain()``, with
the sync-debug mode of ``enable(waits=True)`` set aside for that read, so
it is never counted as a wait. The state is the process's, as the kernels'
launch counters are; ``drain()`` reads those counters' deltas since
``enable()`` and keeps no second count.
"""
from __future__ import annotations

import contextlib
import threading
import time
import warnings

import torch
import torch.autograd.profiler as _prof

# the sync-debug mode's warning (c10/cuda: "called a synchronizing CUDA
# operation")
WAIT_TEXT = "called a synchronizing CUDA operation"

_NULL = contextlib.nullcontext()
_on = False            # recording: enable() .. disable()
_open: list = []       # the open spans, outermost first, every thread
_records: list = []    # closed spans while recording
_counts: dict = {}
_gauges: dict = {}     # name -> [device tensors of one element]
_held = None           # what held() keeps: counts, gauges, launches
_sites: dict = {}      # (span, "file:line") -> waits
_next_id = 0
_next_step = 0
_launch_base: dict = {}
_waits = None          # what enable(waits=True) changed, to restore


class Span:
    """One span: a context manager while open, a record once closed."""

    __slots__ = ("name", "id", "parent", "step", "start_ns", "end_ns",
                 "thread", "_new_step", "_rf", "_kept")

    def __init__(self, name: str, step: bool):
        self.name, self._new_step = name, step
        self.id = self.parent = self.step = self.thread = None
        self.start_ns = self.end_ns = 0
        self._rf = None
        self._kept = False

    def __enter__(self):
        global _next_id, _next_step
        me = threading.get_ident()
        top = _open[-1] if _open else None
        if top is not None and top.name == self.name and top.thread == me:
            return self           # the same layer entered again: nothing
        self.thread, self._kept = me, _on
        _next_id += 1
        self.id = _next_id
        if top is not None:
            self.parent, self.step = top.id, top.step
        if self._new_step:
            _next_step += 1
            self.step = _next_step
        if _prof._is_profiler_enabled:
            self._rf = _prof.record_function(self.name)
            self._rf.__enter__()
        _open.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.id is None:
            return False
        self.end_ns = time.perf_counter_ns()
        if _open and _open[-1] is self:
            _open.pop()
        else:
            _open.remove(self)
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        if self._kept and _on:
            _records.append(self)
        return False

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns


def span(name: str, step: bool = False):
    """A span named ``name`` around a ``with`` block (see the module's
    docstring); ``step`` gives it, and the spans inside it, a new step id.
    Off, and with no profiler recording, the shared null context."""
    if not (_on or _prof._is_profiler_enabled):
        return _NULL
    return Span(name, step)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while recording, and inside
    ``held()``."""
    if _on:
        _counts[name] = _counts.get(name, 0) + n
    if _held is not None:
        _held["counts"][name] = _held["counts"].get(name, 0) + n


def gauging() -> bool:
    """Whether a ``gauge`` would be kept: a caller builds its parts only
    then."""
    return _on or _held is not None


def gauge(name: str, parts) -> None:
    """Set the gauge ``name`` to the total of ``parts`` (tensors of one
    integer element each, on any device), while recording and inside
    ``held()``. The tensors are kept, not read: ``drain()`` reads them."""
    if _on:
        _gauges[name] = list(parts)
    if _held is not None:
        _held["gauges"][name] = list(parts)


@contextlib.contextmanager
def held():
    """Keep what the ``with`` block counts, whether recording or not: it
    yields a dict that holds, once the block ends, its ``counts``, its
    ``gauges`` and its kernels' ``launches`` (deltas of
    ``debug.launch_counts``). ``repeat`` adds them again."""
    global _held
    outer, before = _held, _launches()
    got = {"counts": {}, "gauges": {}, "launches": {}}
    _held = got
    try:
        yield got
    finally:
        _held = outer
        got["launches"] = {k: n - before.get(k, 0)
                           for k, n in _launches().items()
                           if n != before.get(k, 0)}


def repeat(got: dict) -> None:
    """What a replay of the block that ``held()`` kept as ``got`` counts:
    its launches to the kernels' launch counters, and while recording its
    counters added and its gauges set."""
    from .debug import add_launches
    add_launches(got["launches"])
    if _on:
        for k, n in got["counts"].items():
            _counts[k] = _counts.get(k, 0) + n
        _gauges.update(got["gauges"])


def _launches() -> dict:
    from .debug import launch_counts
    return launch_counts()


def _on_warning(message, category, filename, lineno, file=None, line=None):
    if WAIT_TEXT not in str(message):
        _waits["showwarning"](message, category, filename, lineno, file, line)
        return
    where = _open[-1].name if _open else "outside"
    key = f"waits.{where}"
    _counts[key] = _counts.get(key, 0) + 1
    site = (where, f"{filename}:{lineno}")
    _sites[site] = _sites.get(site, 0) + 1


def enable(waits: bool = False) -> None:
    """Start recording spans and counters (and, with ``waits``, the host's
    waits on the card by site). Raises if recording is already on."""
    global _on, _waits
    if _on:
        raise RuntimeError("tracing is already enabled")
    _records.clear()
    _counts.clear()
    _gauges.clear()
    _sites.clear()
    _launch_base.clear()
    _launch_base.update(_launches())
    if waits:
        caught = warnings.catch_warnings()
        caught.__enter__()
        _waits = {"caught": caught, "showwarning": warnings.showwarning,
                  "mode": None}
        warnings.filterwarnings("always", message=f".*{WAIT_TEXT}")
        warnings.showwarning = _on_warning
        if torch.cuda.is_available():
            _waits["mode"] = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
    _on = True


def disable() -> None:
    """Stop recording; restore the sync-debug mode and the warning filters
    that ``enable(waits=True)`` changed. What was recorded stays for
    ``drain()``."""
    global _on, _waits
    _on = False
    if _waits is not None:
        if _waits["mode"] is not None:
            torch.cuda.set_sync_debug_mode(_waits["mode"])
        _waits["caught"].__exit__(None, None, None)
        _waits = None


def _read(parts) -> int:
    """A gauge's total on the host: a copy a part (one on a frame of one
    row band), which waits for the work that writes it and is not counted
    as a wait."""
    quiet = _waits is not None and _waits["mode"] is not None
    if quiet:
        torch.cuda.set_sync_debug_mode(0)
    try:
        return sum(int(p) for p in parts)
    finally:
        if quiet:
            torch.cuda.set_sync_debug_mode("warn")


def drain() -> dict:
    """What was recorded since ``enable()`` or the last ``drain()``, which
    it clears: ``spans`` (closed ``Span`` records by start), ``counts`` (the
    counters, with each kernel's launches since then as
    ``launches.<kernel>`` where they moved, and each gauge set since then
    read as its total) and ``wait_sites`` ([span, "file:line", waits])."""
    counts = dict(_counts)
    now = _launches()
    for k, v in now.items():
        if v != _launch_base.get(k, 0):
            counts[f"launches.{k}"] = v - _launch_base.get(k, 0)
    for k, parts in _gauges.items():
        counts[k] = _read(parts)
    _gauges.clear()
    out = {"spans": sorted(_records, key=lambda r: r.start_ns),
           "counts": counts,
           "wait_sites": [[s, where, n] for (s, where), n in _sites.items()]}
    _records.clear()
    _counts.clear()
    _sites.clear()
    _launch_base.clear()
    _launch_base.update(now)
    return out


@contextlib.contextmanager
def recorded():
    """Record inside a ``with`` block, which yields the list that receives
    the spans closed in it when it ends. Where recording is on already, the
    caller's records and counters stay as they are."""
    own = not _on
    if own:
        enable()
    first = len(_records)
    got: list = []
    try:
        yield got
    finally:
        got.extend(_records[first:])
        if own:
            disable()
            drain()


def self_ns(records) -> dict:
    """Each record's self time by id: its duration less the union of its
    child spans' intervals (clipped to it)."""
    kids: dict = {}
    for r in records:
        if r.parent is not None:
            kids.setdefault(r.parent, []).append((r.start_ns, r.end_ns))
    out = {}
    for r in records:
        covered, reach = 0, r.start_ns
        for s, e in sorted(kids.get(r.id, ())):
            s, e = max(s, reach), min(e, r.end_ns)
            if e > s:
                covered += e - s
                reach = e
        out[r.id] = r.ns - covered
    return out


def by_name(records) -> dict:
    """Per span name: how many, their total and their self milliseconds."""
    own = self_ns(records)
    out: dict = {}
    for r in records:
        t = out.setdefault(r.name, {"n": 0, "total_ms": 0.0, "self_ms": 0.0})
        t["n"] += 1
        t["total_ms"] += r.ns * 1e-6
        t["self_ms"] += own[r.id] * 1e-6
    return out
