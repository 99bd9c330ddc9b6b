"""The reference's live viewer: the closed loop of ``preview.LiveLoop.tick``.

Before each frame one key is pressed (``loop.ctl.key``), drawn from the seed
as blocks that each hold every key of the mix's table once, in a shuffled
order: every seed presses the same keys as often and the camera stays
within a few steps of its start, so the work does not drift with the seed.
Then ``tick()`` steps the light, applies the camera, runs ``render()``
(shadow quads detected on every call) and fetches the float image to the
host. A frame's latency is the host clock from the key to ``tick()``'s
return.

The check draws frames of the window from the seed (a reservoir sample, so
every frame of the window is as likely), works out each one's camera and
light from the keys alone (``reference.live.Viewer``), renders it with the
plain reference and compares it with the fetched image: the share of
pixels off by more than ``TIGHT`` in some channel, and the mean absolute
difference, each by the worst frame.
"""
from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np
import torch

from ..reference import live
from ..reference import render as ref

TIGHT = 3e-4   # the port's parity budget's tight tolerance (tests/conftest.py)
DETECT_SCENES = 50


@dataclasses.dataclass
class State:
    loop: object               # the program's LiveLoop
    keys: "KeyStream"
    check_frames: int          # frames the check compares
    rng: np.random.Generator   # draws them
    frame: int = 0             # frames shown so far, warm-up included
    first_window_frame: int = 0
    sample: list = dataclasses.field(default_factory=list)
    scenes: collections.deque = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=DETECT_SCENES))


class KeyStream:
    """Key names, frame by frame, from the seed: shuffled blocks that each
    hold every key once."""

    def __init__(self, names, rng: np.random.Generator):
        self.names, self.rng, self.keys = list(names), rng, []

    def __getitem__(self, f: int) -> str:
        while len(self.keys) <= f:
            self.keys += [self.names[i]
                          for i in self.rng.permutation(len(self.names))]
        return self.keys[f]


def setup(run) -> State:
    from uob_raytracer_tpu_torch.config import RenderConfig
    from uob_raytracer_tpu_torch.preview import LiveLoop
    from uob_raytracer_tpu_torch.scene import Scene
    leaves = run.leaves()
    run.inputs = {k: v.clone() for k, v in leaves.items()}
    if run.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(run.device)
    st = State(loop=LiveLoop(Scene(**leaves),
                             RenderConfig(**run.config["render"])),
               keys=KeyStream(run.mix["keys"], run.rng(2)),
               check_frames=int(run.mix["check_frames"]), rng=run.rng(3))
    for _ in range(int(run.mix["warmup_frames"])):
        call(st)
    st.first_window_frame = st.frame
    return st


def call(st: State) -> np.ndarray:
    """One key and one frame of the program; the fetched image."""
    st.loop.ctl.key(st.keys[st.frame])
    img = st.loop.tick()
    st.frame += 1
    return img


def window(st: State, seconds: float) -> dict:
    lat, host, fetch = [], 0.0, 0.0
    k, seen = st.check_frames, 0
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        t = time.perf_counter()
        if t >= deadline:
            break
        f = st.frame
        img = call(st)
        lat.append(time.perf_counter() - t)
        host += st.loop.split[0]
        fetch += st.loop.split[1]
        st.scenes.append(st.loop.frame_scene)
        seen += 1
        if len(st.sample) < k:
            st.sample.append((f, img))
        else:
            j = int(st.rng.integers(seen))
            if j < k:
                st.sample[j] = (f, img)
    return {"calls": seen, "elapsed_s": time.perf_counter() - t0,
            "latency_s": lat, "tick_host_s": host, "fetch_s": fetch}


def layer_spans(st: State, run) -> None:
    """Shadow-quad detection timed alone on the window's last scenes."""
    if run.device.type != "cuda":
        return
    from uob_raytracer_tpu_torch.ops.quads import detect_shadow_quads
    ts = []
    for s in st.scenes:
        t = time.perf_counter()
        detect_shadow_quads(s)
        ts.append(time.perf_counter() - t)
    run.spans["quad_detect_s"] = float(np.mean(ts))


def viewer(run, frame: int) -> "live.Viewer":
    """The reference's view after ``frame`` + 1 frames."""
    host = {k: v.cpu().numpy() for k, v in run.inputs.items()}
    v = live.Viewer(host, run.mix["keys"])
    keys = KeyStream(run.mix["keys"], run.rng(2))
    for f in range(frame + 1):
        v.frame(keys[f])
    return v


def ray_stats(st: State, run):
    v = viewer(run, st.first_window_frame)
    return ref.ray_stats(v.leaves(run.inputs, run.device), run.params)


def compare(img: np.ndarray, want: torch.Tensor) -> dict:
    diff = np.abs(img - want.cpu().numpy())
    return {"px_off_pct": 100.0 * float((diff.max(axis=-1) > TIGHT).mean()),
            "mean_abs": float(diff.mean())}


def reference_image(run, frame: int, dtype=torch.float32) -> torch.Tensor:
    v = viewer(run, frame)
    leaves = {k: t.to(dtype) for k, t in
              v.leaves(run.inputs, run.device).items()}
    return ref.render_image(leaves, run.params).float()


def check(st: State, run) -> dict:
    sample = sorted(st.sample, key=lambda s: s[0])
    st.loop = None
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
        torch.cuda.empty_cache()
    out = {"px_off_pct": 0.0, "mean_abs": 0.0}
    for f, img in sample:
        r = compare(img, reference_image(run, f))
        out = {k: max(out[k], r[k]) for k in out}
    return out
