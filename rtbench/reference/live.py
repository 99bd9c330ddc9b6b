"""The reference's live viewer, worked out from the keys alone: the camera
and the light of every frame of the live loop.

The reference's event loop (harrywaugh/UOB_Raytracer
``Source/skeleton.cpp:282-361``) moves the camera by fixed increments per
key press (the traffic mix's ``keys`` table) and steps the light once per
frame (``skeleton.cpp:290-298``: an exponential approach toward x = -0.5,
then toward +0.5, turning where the step is under 1e-3). The state is held
in Python floats and rounded to float32 when a frame is rendered.
"""
from __future__ import annotations

import numpy as np
import torch


def light_step(x: float, left: bool) -> tuple[float, bool]:
    """One step of the light's oscillation along x."""
    if left:
        diff = -0.5 - x
        if diff > -0.001:
            left = False
    else:
        diff = 0.5 - x
        if diff < 0.001:
            left = True
    return x + diff / 20.0, left


class Viewer:
    """The camera and light state of the live loop, from a scene's leaves
    (numpy) and the mix's key table."""

    def __init__(self, leaves: dict, keys: dict):
        self.keys = keys
        cam = leaves["camera_pos"]
        self.cam = {"yaw": float(leaves["yaw"]),
                    "pitch": float(leaves["pitch"]), "cam_x": float(cam[0]),
                    "cam_y": float(cam[1]), "cam_z": float(cam[2])}
        light = np.asarray(leaves["light_pos"], np.float32)
        self.light_x, self.left = float(light[0]), True
        self.light_yz = light[1:]

    def frame(self, key: str) -> None:
        """A key press, then the light's step: the state one frame shows."""
        for k, v in self.keys[key].items():
            self.cam[k] += v
        self.light_x, self.left = light_step(self.light_x, self.left)

    def leaves(self, base: dict, device) -> dict:
        """``base`` (tensors) with this frame's camera and light."""
        c = self.cam
        state = np.array([c["yaw"], c["pitch"], c["cam_x"], c["cam_y"],
                          c["cam_z"]], dtype=np.float32)
        light = np.array([self.light_x, *self.light_yz], dtype=np.float32)
        t = torch.from_numpy(np.concatenate([state, light])).to(device)
        return dict(base, yaw=t[0], pitch=t[1], camera_pos=t[2:5],
                    light_pos=t[5:8])
