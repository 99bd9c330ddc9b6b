"""Local preview and the live loop — the counterpart of ``scripts/preview.py``.

The reference presents frames in a live SDL window with vsync
(``Source/SDLauxiliary.h:73-147``) and animates the light in its event loop
(``Source/skeleton.cpp:282-361``). There is no SDL here; this module renders
the same light animation and either

* assembles an animated GIF (default; PPM frames where Pillow is missing),
* plays the frames in a local Tk window (``--show``, needs a display),
* runs the live loop in a Tk window with the reference's mouse and keyboard
  camera control (``--interactive``, needs a display), or
* drives that loop headlessly and times each keypress -> updated frame on
  the host (``--latency-bench``).

Every frame of every mode is one ``LiveLoop.tick``: the light animation
step, the controller's camera, ``render()`` and the fetch of the float image
to the host, which plays the SDL present's role. Scenes go to ``cuda:0``
unless ``--device cpu`` is given; on the card every frame is the forward
kernel's (K1, or K3f past 320 triangles).

Usage (``scripts/preview_torch.py`` calls ``main``):
    python scripts/preview_torch.py                        # preview.gif, 48 frames
    python scripts/preview_torch.py --width 512 --frames 90 -o cornell.gif
    python scripts/preview_torch.py --show                 # live window (if DISPLAY)
    python scripts/preview_torch.py --interactive          # mouse/keys drive the camera
    python scripts/preview_torch.py --latency-bench --width 256 --bounces 1
    python scripts/preview_torch.py --device cpu --latency-bench --width 32
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from . import tracing
from .config import RenderConfig
from .interactive import CameraController
from .kernels import render_fwd
from .ops.image import to_u8
from .render import render
from .scene import add_triangles, animate_light, cornell_box, load_obj

# the latency bench's event stream (scripts/preview.py:240)
KEYS = ("Left", "Right", "Up", "Down", "i", "o", "k", "j")


def config(args) -> RenderConfig:
    return RenderConfig(width=args.width, height=args.width, aa_x=2, aa_y=2,
                        shadow_samples=args.samples, bounces=args.bounces)


def build_scene(args):
    """The Cornell box (plus ``--obj``) on ``cuda:0``, or on the CPU with
    ``--device cpu``."""
    device = torch.device("cpu" if args.device == "cpu" else "cuda:0")
    scene = cornell_box(device=device)
    if args.obj:
        scene = add_triangles(scene, *load_obj(args.obj))
    return scene


class LiveLoop:
    """The state of the live loop — scene, config, camera controller, light
    oscillation — and one tick of it."""

    def __init__(self, scene, cfg: RenderConfig):
        self.scene, self.cfg = scene, cfg
        light = scene.light_pos.detach().cpu().numpy()
        cam = scene.camera_pos.detach().cpu().numpy()
        self.ctl = CameraController(cam_z=float(cam[2]))
        self.light_x, self.lor = float(light[0]), True
        self._light_yz = light[1:]
        self.frame_scene = None   # the scene the last tick rendered
        self.split = (0.0, 0.0)   # its host seconds: (to launch, fetch)

    def tick(self) -> np.ndarray:
        """One frame (``scripts/preview.py:170-182, 223-228``): the light
        steps, the controller's camera is applied, ``render()`` runs (shadow
        quads detected on the frame's scene, as on every call) and the
        float image [H, W, 3] is fetched to the host. ``split`` keeps the
        host seconds up to render()'s return and of the fetch, which on the
        card waits for the kernel."""
        with tracing.span("rt.tick", step=True):
            t0 = time.perf_counter()
            self.light_x, self.lor = animate_light(self.light_x, self.lor)
            s = self.ctl.apply(self.scene)
            light = np.array([self.light_x, *self._light_yz],
                             dtype=np.float32)
            s = dataclasses.replace(
                s, light_pos=torch.as_tensor(light, device=s.device))
            out = render(s, self.cfg)
            t1 = time.perf_counter()
            img = out.image.cpu().numpy()     # the fetch = the SDL present
            self.split = (t1 - t0, time.perf_counter() - t1)
            self.frame_scene = s
            return img


def _u8(img: np.ndarray) -> np.ndarray:
    """A host frame as uint8 RGB (``ops.image.to_u8``)."""
    return to_u8(torch.from_numpy(img)).numpy()


def render_frames(args) -> list[np.ndarray]:
    """Render the light-oscillation sequence (skeleton.cpp:290-298) as
    uint8 frames."""
    loop = LiveLoop(build_scene(args), config(args))
    frames, t_total = [], 0.0
    for f in range(args.frames):
        t0 = time.perf_counter()
        img = loop.tick()
        if f > 0:   # the first frame builds and loads the kernels
            t_total += time.perf_counter() - t0
        frames.append(_u8(img))
        print(f"\rframe {f + 1}/{args.frames}", end="", flush=True)
    if args.frames > 1:
        dt = t_total / (args.frames - 1)
        print(f"\nsteady-state {dt * 1e3:.2f} ms/frame = {1 / dt:.1f} FPS")
    return frames


def save_gif(frames, path: str, fps: float) -> bool:
    """An animated GIF; without Pillow, PPM frames in a directory named
    after ``path``. Returns whether the GIF was written."""
    try:
        from PIL import Image
    except ImportError:
        print("Pillow not available — writing PPM frames instead "
              "(view with any image tool)", file=sys.stderr)
        from .ops.image import save_ppm
        base = os.path.splitext(path)[0]
        os.makedirs(base, exist_ok=True)
        for i, f in enumerate(frames):
            save_ppm(os.path.join(base, f"frame_{i:04d}.ppm"),
                     f.astype(np.float32) / 255.0)
        print(f"wrote {len(frames)} frames to {base}/")
        return False
    imgs = [Image.fromarray(f) for f in frames]
    imgs[0].save(path, save_all=True, append_images=imgs[1:],
                 duration=max(int(1000 / fps), 20), loop=0)
    print(f"wrote {path} ({len(frames)} frames)")
    return True


def show_window(frames, fps: float) -> None:
    """Best-effort live playback in a Tk window (the SDL-window analogue)."""
    try:
        import tkinter as tk

        from PIL import Image, ImageTk
    except ImportError as e:
        print(f"--show needs tkinter + Pillow ({e}); falling back to GIF "
              f"only", file=sys.stderr)
        return
    try:
        root = tk.Tk()
    except tk.TclError as e:
        print(f"--show: no display available ({e}); view the GIF instead",
              file=sys.stderr)
        return
    root.title("uob_raytracer_tpu_torch preview (Esc to quit)")
    label = tk.Label(root)
    label.pack()
    photos = [ImageTk.PhotoImage(Image.fromarray(f)) for f in frames]
    state = {"i": 0}

    def tick():
        label.configure(image=photos[state["i"]])
        state["i"] = (state["i"] + 1) % len(photos)
        root.after(max(int(1000 / fps), 20), tick)

    root.bind("<Escape>", lambda e: root.destroy())
    tick()
    root.mainloop()


def interactive_window(args) -> None:
    """Live render-as-you-watch loop — the reference's SDL event loop
    (skeleton.cpp:282-361) on Tk: mouse motion and arrows drive yaw/pitch,
    i/o/k/j translate the camera (the reference's increments, see
    ``interactive.py``), the light keeps oscillating, and every frame is a
    fresh ``LiveLoop.tick``."""
    try:
        import tkinter as tk

        from PIL import Image, ImageTk
    except ImportError as e:
        print(f"--interactive needs tkinter + Pillow ({e})", file=sys.stderr)
        return
    try:
        root = tk.Tk()
    except tk.TclError as e:
        print(f"--interactive: no display available ({e})", file=sys.stderr)
        return
    loop = LiveLoop(build_scene(args), config(args))
    ctl = loop.ctl
    root.title("uob_raytracer_tpu_torch live (arrows/mouse rotate, iokj "
               "move, Esc quits)")
    label = tk.Label(root)
    label.pack()
    last = {"xy": None, "photo": None, "t": time.time(), "n": 0}

    def on_motion(e):
        # Tk reports absolute coords; SDL's xrel/yrel is the frame delta
        if last["xy"] is not None:
            ctl.mouse_motion(e.x - last["xy"][0], e.y - last["xy"][1])
        last["xy"] = (e.x, e.y)

    def on_key(e):
        ctl.key(e.keysym)
        if ctl.quit:
            root.destroy()

    root.bind("<B1-Motion>", on_motion)
    root.bind("<ButtonRelease-1>", lambda e: last.update(xy=None))
    root.bind("<KeyPress>", on_key)

    def tick():
        last["photo"] = ImageTk.PhotoImage(Image.fromarray(_u8(loop.tick())))
        label.configure(image=last["photo"])
        last["n"] += 1
        if last["n"] % 30 == 0:
            dt = (time.time() - last["t"]) / 30
            root.title(f"uob_raytracer_tpu_torch live — {1 / dt:.1f} FPS "
                       f"(yaw {ctl.yaw:+.2f} pitch {ctl.pitch:+.2f})")
            last["t"] = time.time()
        root.after(1, tick)

    tick()
    root.mainloop()


def card_name() -> str:
    """The card's name and power limit as nvidia-smi gives them (the first
    card CUDA_VISIBLE_DEVICES names, or card 0)."""
    card = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0] or "0"
    return subprocess.run(
        ["nvidia-smi", f"--id={card}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def forward_device_ms(loop: LiveLoop, ticks: int = 5) -> float:
    """Mean device time of the forward kernel (K1 or K3f) in a tick, from
    torch.profiler over ``ticks`` ticks; the profiler may drop some
    launches' records, so the mean is over those it kept, at least half,
    in at most three runs."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    kept = []
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(ticks):
                loop.tick()
            torch.cuda.synchronize()
        rows = [k for k in prof.key_averages() if "render_fwd" in k.key]
        n = sum(k.count for k in rows)
        kept.append(n)
        if ticks <= 2 * n <= 2 * ticks:
            return sum(k.self_device_time_total for k in rows) / n / 1e3
    raise RuntimeError(f"the profiler kept {kept} of {ticks} forward kernel "
                       f"launches in three runs")


def latency_bench(args, loop: LiveLoop | None = None,
                  events: int = 32) -> dict:
    """Keypress -> updated frame on the host, through the live loop: for
    each of ``events`` key events (the JAX bench's 32: the eight keys four
    times), ``time.perf_counter`` around the controller's key and one
    ``LiveLoop.tick``, whose fetch synchronises. The warm-up tick, which
    builds and loads the kernels, is left out.

    Beside the latency: the forward kernel's device time per frame (on the
    card, from torch.profiler), the host split of a frame (quad detection,
    which ``render()`` runs in Python on every call, from the frame's
    ``rt.render.quads`` spans; the rest of the work up to ``render()``'s
    return: the light, the camera, packing and the launch; the fetch, which
    waits for the kernel and copies the image to the host), and the floor
    of a 1-element fetch (``.item()``)."""
    loop = loop or LiveLoop(build_scene(args), config(args))
    cfg, dev = loop.cfg, loop.scene.device
    on_card = dev.type == "cuda"
    loop.tick()   # build and load the kernels, warm the caches

    one = torch.zeros((), device=dev)
    (one + 1.0).item()
    t0 = time.perf_counter()
    for _ in range(5):
        (one + 1.0).item()
    fetch_floor_ms = (time.perf_counter() - t0) / 5 * 1e3

    keys = [KEYS[i % len(KEYS)] for i in range(events)]
    lats, host, fetch = [], [], []
    finite = True
    launches = render_fwd.LAUNCHES + render_fwd.STREAMED_LAUNCHES
    with tracing.recorded() as spans:
        for name in keys:
            t0 = time.perf_counter()
            loop.ctl.key(name)            # the keypress
            img = loop.tick()             # re-render + fetch
            lats.append((time.perf_counter() - t0) * 1e3)
            host.append(loop.split[0] * 1e3)
            fetch.append(loop.split[1] * 1e3)
            finite = finite and bool(np.isfinite(img).all())
    launches = render_fwd.LAUNCHES + render_fwd.STREAMED_LAUNCHES - launches

    # quad detection happens inside render() (on a CUDA scene's fused
    # path): each frame's rt.render.quads spans, taken out of the host part
    quads_ns = {r.step: 0 for r in spans if r.name == "rt.tick"}
    for r in spans:
        if r.name == "rt.render.quads":
            quads_ns[r.step] += r.ns
    detect_ms = statistics.median(quads_ns.values()) * 1e-6
    lats_ms = sorted(lats)
    n = len(lats_ms)
    p50 = lats_ms[n // 2]
    host_ms = statistics.median(host)
    out = {
        "width": cfg.width,
        "config": f"aa{cfg.aa_rays} s{cfg.shadow_samples} b{cfg.bounces}",
        "n_events": n,
        "keypress_to_frame_ms": {"p50": p50, "p95": lats_ms[int(n * 0.95)],
                                 "min": lats_ms[0]},
        "fps_at_p50": 1e3 / p50,
        "fetch_floor_ms": fetch_floor_ms,
        "forward_device_ms": forward_device_ms(loop) if on_card else None,
        "host_split_ms": {
            "quad_detect": detect_ms,
            "light_camera_pack_launch": host_ms - detect_ms,
            "fetch": statistics.median(fetch)},
        "quad_detect_share_of_p50": detect_ms / p50,
        "forward_launches": launches,
        "all_frames_finite": finite,
        "device": str(dev),
        "card": card_name() if on_card else None,
        "note": "keypress -> updated frame on the host through "
                "LiveLoop.tick (key, light step, camera, render() with "
                "quad detection, fetch of the float image); host split: "
                "medians of the events' frames, quad detection from each "
                "frame's rt.render.quads spans",
    }
    dev_ms = out["forward_device_ms"]
    print(f"latency {cfg.width}^2 {out['config']} on "
          f"{out['card'] or dev}: p50 {p50:.3f} ms (p95 "
          f"{out['keypress_to_frame_ms']['p95']:.3f}, min {lats_ms[0]:.3f}, "
          f"{out['fps_at_p50']:.1f} FPS); forward kernel "
          f"{'not measured' if dev_ms is None else f'{dev_ms:.4f} ms'}; host "
          f"split: quad detection {detect_ms:.3f} ms, light/camera/pack/"
          f"launch {host_ms - detect_ms:.3f} ms, fetch "
          f"{out['host_split_ms']['fetch']:.3f} ms; 1-element fetch floor "
          f"{fetch_floor_ms:.3f} ms", flush=True)
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="preview_torch.py")
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--frames", type=int, default=48)
    p.add_argument("--samples", type=int, default=10)
    p.add_argument("--bounces", type=int, default=10)
    p.add_argument("--fps", type=float, default=24.0)
    p.add_argument("--obj", default=None)
    p.add_argument("--device", default=None, choices=["cpu"],
                   help="'cpu' runs on the CPU (the kernels' plain "
                        "versions); default: cuda:0")
    p.add_argument("--show", action="store_true",
                   help="play in a local window (needs a display)")
    p.add_argument("--interactive", action="store_true",
                   help="live window with mouse/keyboard camera control "
                        "(the reference's event loop; needs a display)")
    p.add_argument("--latency-bench", action="store_true",
                   help="headless keypress->frame latency of the live loop")
    p.add_argument("-o", "--out", default="preview.gif")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    if args.latency_bench:
        print(json.dumps(latency_bench(args)))
        return
    if args.interactive:
        interactive_window(args)
        return
    frames = render_frames(args)
    save_gif(frames, args.out, args.fps)
    if args.show:
        show_window(frames, args.fps)
