"""Scene definition: geometry, materials, light, camera — as torch tensors.

The counterpart of ``uob_raytracer_tpu/scene.py``: the same 15 SoA float32
leaves, held in a plain dataclass instead of a JAX pytree. The scene has no
layers, so it is not an ``nn.Module``; its leaves can go to ``torch.optim``
as they are. Every function that renders a scene takes its device from the
scene's tensors, and ``Scene.to`` is the one place that moves them.

Material encoding follows the reference convention (``Source/TestModelH.h:58-59``):
``mat > 0`` diffuse, ``mat == 0`` mirror, ``mat == -1`` glass.

The constant tables (the Cornell triangles, the analytic spheres, the OBJ
loader) are built in numpy exactly as the JAX package builds them, so a
scene made here is bit-identical to the JAX package's ``cornell_box``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import ShadingModel

MAT_DIFFUSE = 1.0
MAT_MIRROR = 0.0
MAT_GLASS = -1.0


@dataclasses.dataclass
class Scene:
    """SoA scene. All leaves are float32 tensors on one device."""

    # Triangles: vertices [T,3] each, colors [T,3], material code [T].
    tri_v0: torch.Tensor
    tri_v1: torch.Tensor
    tri_v2: torch.Tensor
    tri_rgb: torch.Tensor
    tri_mat: torch.Tensor
    # Analytic spheres: centers [S,3], squared radii [S], colors [S,3], mat [S].
    sph_center: torch.Tensor
    sph_r2: torch.Tensor
    sph_rgb: torch.Tensor
    sph_mat: torch.Tensor
    # Point light (animated along x by the reference's update loop,
    # skeleton.cpp:290-298) and shading constants.
    light_pos: torch.Tensor      # [3]
    light_color: torch.Tensor    # [3]
    indirect_light: torch.Tensor  # [3]
    # Camera: position [3] plus yaw/pitch scalars (skeleton.cpp:61-66).
    camera_pos: torch.Tensor
    yaw: torch.Tensor
    pitch: torch.Tensor

    @property
    def num_triangles(self) -> int:
        return self.tri_v0.shape[0]

    @property
    def num_spheres(self) -> int:
        return self.sph_center.shape[0]

    @property
    def device(self) -> torch.device:
        return self.tri_v0.device

    def to(self, device) -> "Scene":
        """The same scene with every leaf on ``device``."""
        return Scene(**{f.name: getattr(self, f.name).to(device)
                        for f in dataclasses.fields(Scene)})


def compute_normals(v0, v1, v2):
    """Unit normals from vertices: normalize(cross(e2, e1)).

    Matches ``Triangle::ComputeNormal`` (``Source/TestModelH.h:26-35``) —
    note the cross-product argument order (e2 first)."""
    from .ops.math3 import cross3
    n = cross3(v2 - v0, v1 - v0)
    return n / torch.linalg.norm(n, dim=-1, keepdim=True)


def _cornell_triangles() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The 26-triangle Cornell Box of ``Source/TestModelH.h:44-219``.

    Returns (verts [T,3,3], rgb [T,3], mat [T]) as float32, after the
    reference's normalization: scale by 2/555, translate by -1, mirror x and y.
    """
    # Palette (TestModelH.h:50-62); only the colors actually used below.
    red = (0.6, 0.0, 0.0)
    dark_grey = (0.25, 0.25, 0.25)
    dark_yellow = (0.3, 0.3, 0.0)
    dark_green = (0.0, 0.25, 0.0)
    blue = (0.0, 0.2, 0.5)
    dark_purple = (0.25, 0.0, 0.25)
    white = (0.75, 0.75, 0.75)

    tris: list[tuple[tuple, tuple, tuple, tuple]] = []

    def quadset(A, B, C, D, E, F, G, H, color):
        """The 8-triangle block pattern used for both boxes
        (TestModelH.h:130-147 and 172-189; the BACK faces are commented out
        in the reference and therefore absent here too)."""
        tris.extend([
            (E, B, A, color), (E, F, B, color),   # front
            (F, D, B, color), (F, H, D, color),   # side
            (G, E, C, color), (E, A, C, color),   # left
            (G, F, E, color), (G, H, F, color),   # top
        ])

    L = 555.0
    A = (L, 0, 0); B = (0, 0, 0); C = (L, 0, L); D = (0, 0, L)
    E = (L, L, 0); F = (0, L, 0); G = (L, L, L); H = (0, L, L)
    tris.extend([
        (C, B, A, dark_grey), (C, D, B, dark_grey),       # floor
        (A, E, C, dark_purple), (C, E, G, dark_purple),   # left wall
        (F, B, D, dark_green), (H, F, D, dark_green),     # right wall
        (E, F, G, dark_yellow), (F, H, G, dark_yellow),   # ceiling
        (G, D, C, white), (G, H, D, white),               # back wall
        # front wall: commented out in the reference (TestModelH.h:107-108)
    ])

    # Short (red) block, TestModelH.h:116-147.
    quadset((290, 0, 114), (130, 0, 65), (240, 0, 272), (82, 0, 225),
            (290, 165, 114), (130, 165, 65), (240, 165, 272), (82, 165, 225),
            red)
    # Tall (blue) block, TestModelH.h:161-189.
    quadset((423, 0, 247), (265, 0, 296), (472, 0, 406), (314, 0, 456),
            (423, 330, 247), (265, 330, 296), (472, 330, 406), (314, 330, 456),
            blue)

    verts = np.array([[t[0], t[1], t[2]] for t in tris], dtype=np.float32)
    rgb = np.array([t[3] for t in tris], dtype=np.float32)
    mat = np.full((len(tris),), MAT_DIFFUSE, dtype=np.float32)

    # Normalize to [-1,1]^3 exactly as TestModelH.h:195-218: scale, translate,
    # mirror x and y. Done in float32 to match the reference arithmetic.
    verts = verts * np.float32(2.0 / L)
    verts = verts - np.float32(1.0)
    verts[..., 0] *= -1.0
    verts[..., 1] *= -1.0
    return verts, rgb, mat


# The reference kernel's sphere tables hold a THIRD entry — center
# (0, 0, -0.8), r^2=0.1, color (0.6, 0, 0, -1.0) where the w component is
# the material code (-1 = glass) — that the SPHERES=2 loop bound masks off
# (``Source/kernels.cl:7-10``). Kept here verbatim, and masked off the
# same way; pass include_masked=True to resurrect it exactly as raising
# SPHERES would in the reference.
_MASKED_SPHERE = {"center": (0.0, 0.0, -0.8), "r2": 0.1,
                  "rgb": (0.6, 0.0, 0.0), "mat": float(MAT_GLASS)}


def default_spheres(include_masked: bool = False
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                               np.ndarray]:
    """The analytic spheres of ``Source/kernels.cl:7-10``: a glass sphere
    at (0.3, 0.1, -0.5) with r^2=0.075 and a mirror sphere at
    (-0.4, 0.8, -0.5) with r^2=0.05 — plus, with ``include_masked``, the
    third table entry the reference declares but masks off with its
    SPHERES=2 bound (see ``_MASKED_SPHERE``)."""
    centers = [[0.3, 0.1, -0.5], [-0.4, 0.8, -0.5]]
    r2 = [0.075, 0.05]
    rgb = [[0.0, 0.0, 0.0], [0.0, 0.0, 0.0]]
    mat = [MAT_GLASS, MAT_MIRROR]
    if include_masked:
        centers.append(list(_MASKED_SPHERE["center"]))
        r2.append(_MASKED_SPHERE["r2"])
        rgb.append(list(_MASKED_SPHERE["rgb"]))
        mat.append(_MASKED_SPHERE["mat"])
    return (np.array(centers, dtype=np.float32),
            np.array(r2, dtype=np.float32),
            np.array(rgb, dtype=np.float32),
            np.array(mat, dtype=np.float32))


def cornell_box(
    *,
    spheres: bool = True,
    masked_sphere: bool = False,
    shading: ShadingModel = ShadingModel.DEVICE,
    device=None,
) -> Scene:
    """Build the golden Cornell Box scene on ``device`` (default: the
    current CUDA device; pass ``device="cpu"`` for the CPU).

    shading selects between the live device constants (light 16, indirect 0.5,
    ``kernels.cl:3-4``) and the vestigial host constants (light 14, indirect
    0.25, ``skeleton.cpp:69-70``) used by the CPU-ref baseline config.
    masked_sphere resurrects the reference's third, SPHERES=2-masked table
    entry (see ``_MASKED_SPHERE``).
    """
    verts, rgb, mat = _cornell_triangles()
    if spheres:
        sc, sr2, srgb, smat = default_spheres(include_masked=masked_sphere)
    else:
        sc = np.zeros((0, 3), dtype=np.float32)
        sr2 = np.zeros((0,), dtype=np.float32)
        srgb = np.zeros((0, 3), dtype=np.float32)
        smat = np.zeros((0,), dtype=np.float32)

    if shading == ShadingModel.DEVICE:
        light_color = np.array([16.0, 16.0, 16.0], dtype=np.float32)
        indirect = np.array([0.5, 0.5, 0.5], dtype=np.float32)
    else:
        light_color = np.array([14.0, 14.0, 14.0], dtype=np.float32)
        indirect = np.array([0.25, 0.25, 0.25], dtype=np.float32)

    return scene_from_numpy(dict(
        tri_v0=verts[:, 0],
        tri_v1=verts[:, 1],
        tri_v2=verts[:, 2],
        tri_rgb=rgb,
        tri_mat=mat,
        sph_center=sc,
        sph_r2=sr2,
        sph_rgb=srgb,
        sph_mat=smat,
        light_pos=np.array([0.0, -0.5, -0.7], dtype=np.float32),
        light_color=light_color,
        indirect_light=indirect,
        camera_pos=np.array([0.0, 0.0, -3.2], dtype=np.float32),
        yaw=np.float32(0.0),
        pitch=np.float32(0.0),
    ), device)


def load_obj(path: str, *, color=(0.0, 0.2, 0.4), mat_code: float = 0.5,
             scale: float = 1.5,
             translate=(-0.4, 1.15, -0.7)) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Minimal OBJ loader mirroring ``Source/Loader.cpp:11-59``: parses ``v``
    and ``f`` records, scales vertices by 1.5, then negates and translates.
    Returns numpy (verts [T,3,3], rgb [T,3], mat [T]) ready for
    ``add_triangles``."""
    vertices: list[list[float]] = []
    faces: list[tuple[int, int, int]] = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                x, y, z = (float(p) for p in parts[1:4])
                vertices.append([scale * x, scale * y, scale * z])
            elif parts[0] == "f":
                i, j, k = (int(p.split("/")[0]) for p in parts[1:4])
                faces.append((i - 1, j - 1, k - 1))
    v = np.asarray(vertices, dtype=np.float32)
    t = np.asarray(translate, dtype=np.float32)
    verts = np.stack([(-v[[i, j, k]] + t) for i, j, k in faces]).astype(np.float32)
    rgb = np.tile(np.asarray(color, dtype=np.float32), (len(faces), 1))
    mat = np.full((len(faces),), np.float32(mat_code), dtype=np.float32)
    return verts, rgb, mat


def add_triangles(scene: Scene, verts, rgb, mat) -> Scene:
    """Append extra triangles (numpy arrays or tensors, e.g. from
    ``load_obj``) to a scene, on the scene's device."""
    def t(x):
        return torch.as_tensor(x, dtype=torch.float32, device=scene.device)

    verts = t(verts)
    return dataclasses.replace(
        scene,
        tri_v0=torch.cat([scene.tri_v0, verts[:, 0]]),
        tri_v1=torch.cat([scene.tri_v1, verts[:, 1]]),
        tri_v2=torch.cat([scene.tri_v2, verts[:, 2]]),
        tri_rgb=torch.cat([scene.tri_rgb, t(rgb)]),
        tri_mat=torch.cat([scene.tri_mat, t(mat)]),
    )


def animate_light(light_x: float, lor: bool) -> tuple[float, bool]:
    """One step of the reference's light oscillation (skeleton.cpp:290-298):
    exponential approach toward x=-0.5 then x=+0.5, flipping at |diff|<1e-3."""
    if lor:
        diff = -0.5 - light_x
        if diff > -0.001:
            lor = False
        light_x += diff / 20.0
    else:
        diff = 0.5 - light_x
        if diff < 0.001:
            lor = True
        light_x += diff / 20.0
    return light_x, lor


# --------------------------------------------------------------------------
# Carrying a scene across: numpy leaves (e.g. ``np.asarray`` of each leaf of
# the JAX package's Scene) <-> this package's Scene, and .npz checkpoints
# with the same keys as the JAX package's ``scene.save_scene``.
# --------------------------------------------------------------------------

def scene_from_numpy(leaves: dict, device=None) -> Scene:
    """Scene from a dict of the 15 leaf arrays, keyed by field name, on
    ``device``. With no device the scene goes to the current CUDA device,
    and a machine without one raises torch's own error; the CPU is used
    when the caller asks for it by name."""
    device = torch.device("cuda" if device is None else device)
    return Scene(**{
        f.name: torch.from_numpy(
            np.array(leaves[f.name], dtype=np.float32)).to(device)
        for f in dataclasses.fields(Scene)})


def scene_to_numpy(scene: Scene) -> dict[str, np.ndarray]:
    """The scene's 15 leaves as float32 numpy arrays, keyed by field name."""
    return {f.name: getattr(scene, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(Scene)}


def save_scene(path: str, scene: Scene) -> None:
    """Checkpoint a scene (all parameters) to .npz."""
    np.savez_compressed(path, **scene_to_numpy(scene))


def load_scene(path: str, device=None) -> Scene:
    """Load a scene checkpoint written by either package's save_scene, onto
    ``device`` (default: the current CUDA device)."""
    with np.load(path) as z:
        return scene_from_numpy({k: z[k] for k in z.files}, device)
