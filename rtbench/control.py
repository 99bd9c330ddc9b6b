"""The check's controls: the readings that set each limit's upper end.

- The precision control: the plain reference put in the program's place and
  computed in bfloat16, the nearest precision below the configurations'
  float32 (the renderer multiplies no matrices, so TF32 changes nothing).
- The faults a cell can have, planted in the program for the length of a
  ``with`` block: ``unchanged`` (a training step that returns its state
  unchanged), ``half_batch`` (the loss's mean taken over half of the
  image's rows), ``stale`` (a frame that shows the previous frame's image)
  and ``altered`` (a block of a frame's pixels altered where the frame is
  made).

    python3 -m rtbench.control --workload <cell> --seeds 1,2,3 [--seconds 1]

runs, for each seed in one process on the card, the program's sound run,
each fault and the control, and prints one JSON line of readings per seed
and source. The benchmark's own runs never run it; ``tests/`` holds it at a
size the CPU can run.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import torch

LOW = torch.bfloat16


@contextlib.contextmanager
def _patch(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


@contextlib.contextmanager
def unchanged():
    """``train_step`` returns the scene it was given."""
    from uob_raytracer_tpu_torch.parallel import train
    real = train.train_step

    def step(scene, *a, **k):
        return real(scene, *a, **k)._replace(scene=scene)
    with _patch(train, "train_step", step):
        yield


@contextlib.contextmanager
def half_batch():
    """The loss is the mean over the image's even rows only."""
    from uob_raytracer_tpu_torch.parallel import train

    def loss(scene, target, cfg, mesh=None, backend="auto",
             shadow_quads=None):
        img = train.render_image_sharded(scene, cfg, mesh, backend=backend,
                                          shadow_quads=shadow_quads)
        return torch.mean(torch.square(img[::2] - target[::2]))
    with _patch(train, "image_loss", loss):
        yield


@contextlib.contextmanager
def stale():
    """``tick`` shows the previous frame's image."""
    from uob_raytracer_tpu_torch import preview
    real = preview.LiveLoop.tick

    def tick(self):
        img = real(self)
        prev = getattr(self, "_stale", img)
        self._stale = img
        return prev
    with _patch(preview.LiveLoop, "tick", tick):
        yield


@contextlib.contextmanager
def altered():
    """A 32x32 block of every frame is brightened by 0.25."""
    from uob_raytracer_tpu_torch import preview
    real = preview.LiveLoop.tick

    def tick(self):
        img = real(self).copy()
        img[:32, :32] += 0.25
        return img
    with _patch(preview.LiveLoop, "tick", tick):
        yield


FAULTS = {"sgd": {"unchanged": unchanged, "half_batch": half_batch},
          "live": {"stale": stale, "altered": altered}}


def _sgd(run, seconds: float) -> dict:
    from .loops import sgd
    loop = run.loop
    st = loop.setup(run)
    loop.window(st, seconds)
    p, names, lr = run.params, st.names, st.lr
    target, first = st.target, st.first
    st.scene = None
    sgd.gc_device(run.device)
    reference = sgd.reference_steps(run.inputs, target, p, names, lr,
                                    len(first["losses"]))
    out = {"program": sgd.readings(first, reference, lr, names)}
    for name, fault in FAULTS["sgd"].items():
        with fault():
            st = loop.setup(run)
        out[name] = sgd.readings(st.first, reference, lr, names)
        st.scene = None
    low = {k: v.to(LOW) for k, v in run.inputs.items()}
    ctrl = sgd.reference_steps(low, target.to(LOW), p, names, lr,
                               len(first["losses"]))
    out["control"] = sgd.readings(ctrl, reference, lr, names)
    return out


def _live(run, seconds: float) -> dict:
    from .loops import live
    loop = run.loop
    refs = {}

    def readings(sample, fn):
        worst = {"px_off_pct": 0.0, "mean_abs": 0.0}
        for f, img in sample:
            if f not in refs:
                refs[f] = live.reference_image(run, f)
            r = live.compare(fn(f, img), refs[f])
            worst = {k: max(worst[k], r[k]) for k in worst}
        return worst

    def sample(fault=None):
        with fault() if fault else contextlib.nullcontext():
            st = loop.setup(run)
            loop.window(st, seconds)
        s, st.loop = st.sample, None
        return s

    kept = sample()
    out = {"program": readings(kept, lambda f, img: img)}
    for name, fault in FAULTS["live"].items():
        out[name] = readings(sample(fault), lambda f, img: img)
    out["control"] = readings(
        kept, lambda f, img: live.reference_image(run, f, LOW).cpu().numpy())
    return out


def readings(run, seconds: float) -> dict:
    """{source: {number: reading}} for one seed: the program, each fault
    the cell can have, and the precision control."""
    return {"sgd": _sgd, "live": _live}[run.mix["loop"]](run, seconds)


def main(argv=None) -> int:
    from . import harness
    a = argparse.ArgumentParser(prog="python3 -m rtbench.control")
    a.add_argument("--workload", required=True)
    a.add_argument("--seeds", required=True)
    a.add_argument("--seconds", type=float, default=1.0)
    args = a.parse_args(argv)
    if not torch.cuda.is_available():
        print("rtbench/control.py: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        run = harness.Run(harness.ROOT, args.workload, seed, args.seconds,
                          False, torch.device("cuda", 0))
        out = readings(run, args.seconds)
        for source, r in out.items():
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "source": source, **r}), flush=True)
        print(f"seed {seed}: {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
