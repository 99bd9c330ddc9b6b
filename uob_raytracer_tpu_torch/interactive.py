"""Interactive camera control — the live input layer of the reference's
event loop (``Source/skeleton.cpp:282-361``), decoupled from any window
toolkit so the mapping is unit-testable on a headless host. A copy of
``uob_raytracer_tpu/interactive.py``: the same constants, increments and
state; ``apply`` builds the port's Scene.

The reference's exact increments:
* mouse motion: ``yaw += xrel * 0.0009; pitch -= yrel * 0.0009``
  (``skeleton.cpp:306-308``)
* arrows: Up ``pitch -= 0.1``, Down ``pitch += 0.1``, Left ``yaw += 0.1``,
  Right ``yaw -= 0.1`` (``skeleton.cpp:313-324``)
* i/o: camera z +-0.1; k/j: camera x +-0.1 (``skeleton.cpp:341-352``)
* Escape quits (``skeleton.cpp:353-355``)

The light keeps oscillating every update regardless of input
(``skeleton.cpp:290-298`` — ``scene.animate_light``).

``uob_raytracer_tpu_torch.preview`` drives this from a Tk window with a live
re-render per frame, and headlessly in its keypress->frame latency bench.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

MOUSE_SENSITIVITY = 0.0009   # per pixel of relative motion
KEY_ANGLE_STEP = 0.1         # arrows, radians
KEY_MOVE_STEP = 0.1          # i/o/k/j, world units


@dataclasses.dataclass
class CameraController:
    """Mutable camera/input state with the reference's update rules. The
    state is held in Python floats (double precision), as in the JAX
    package, and rounded to float32 only when applied to a scene."""

    yaw: float = 0.0
    pitch: float = 0.0
    cam_x: float = 0.0
    cam_y: float = 0.0
    cam_z: float = -3.2      # camera_position (skeleton.cpp:63)
    quit: bool = False

    def mouse_motion(self, xrel: float, yrel: float) -> None:
        """Relative mouse motion in pixels (skeleton.cpp:306-308)."""
        self.yaw += xrel * MOUSE_SENSITIVITY
        self.pitch -= yrel * MOUSE_SENSITIVITY

    def key(self, name: str) -> bool:
        """One key press by name ('Up', 'Down', 'Left', 'Right', 'i', 'o',
        'k', 'j', 'Escape'). Returns True if the key changed anything
        (skeleton.cpp:310-356)."""
        if name == "Up":
            self.pitch -= KEY_ANGLE_STEP
        elif name == "Down":
            self.pitch += KEY_ANGLE_STEP
        elif name == "Left":
            self.yaw += KEY_ANGLE_STEP
        elif name == "Right":
            self.yaw -= KEY_ANGLE_STEP
        elif name == "i":
            self.cam_z += KEY_MOVE_STEP
        elif name == "o":
            self.cam_z -= KEY_MOVE_STEP
        elif name == "k":
            self.cam_x += KEY_MOVE_STEP
        elif name == "j":
            self.cam_x -= KEY_MOVE_STEP
        elif name == "Escape":
            self.quit = True
        else:
            return False
        return True

    def apply(self, scene):
        """Scene with this controller's camera state applied: ``yaw``,
        ``pitch`` and ``camera_pos`` as float32 tensors on the scene's
        device. The values are rounded to float32 on the host and copied
        to that device in one transfer, so a CUDA scene gets no CPU tensor;
        the three leaves are views of that one buffer."""
        state = np.array([self.yaw, self.pitch, self.cam_x, self.cam_y,
                          self.cam_z], dtype=np.float32)
        t = torch.as_tensor(state, device=scene.device)
        return dataclasses.replace(scene, yaw=t[0], pitch=t[1],
                                   camera_pos=t[2:])
