"""The reference's Cornell box, as float32 numpy leaves keyed by the names
the port's ``Scene`` uses: a frozen copy of the port's ``scene.py`` tables
(harrywaugh/UOB_Raytracer, ``Source/TestModelH.h:44-219``; the spheres of
``Source/kernels.cl:7-10``), so that a later change to the program cannot
move what the benchmark renders.
"""
from __future__ import annotations

import numpy as np

MAT_DIFFUSE, MAT_MIRROR, MAT_GLASS = 1.0, 0.0, -1.0


def _cornell_triangles():
    """(verts [26,3,3], rgb [26,3], mat [26]) float32, after the reference's
    normalisation: scale by 2/555, translate by -1, mirror x and y."""
    red = (0.6, 0.0, 0.0)
    dark_grey = (0.25, 0.25, 0.25)
    dark_yellow = (0.3, 0.3, 0.0)
    dark_green = (0.0, 0.25, 0.0)
    blue = (0.0, 0.2, 0.5)
    dark_purple = (0.25, 0.0, 0.25)
    white = (0.75, 0.75, 0.75)
    tris = []

    def quadset(A, B, C, D, E, F, G, H, color):
        tris.extend([(E, B, A, color), (E, F, B, color),
                     (F, D, B, color), (F, H, D, color),
                     (G, E, C, color), (E, A, C, color),
                     (G, F, E, color), (G, H, F, color)])

    L = 555.0
    A = (L, 0, 0); B = (0, 0, 0); C = (L, 0, L); D = (0, 0, L)
    E = (L, L, 0); F = (0, L, 0); G = (L, L, L); H = (0, L, L)
    tris.extend([(C, B, A, dark_grey), (C, D, B, dark_grey),
                 (A, E, C, dark_purple), (C, E, G, dark_purple),
                 (F, B, D, dark_green), (H, F, D, dark_green),
                 (E, F, G, dark_yellow), (F, H, G, dark_yellow),
                 (G, D, C, white), (G, H, D, white)])
    quadset((290, 0, 114), (130, 0, 65), (240, 0, 272), (82, 0, 225),
            (290, 165, 114), (130, 165, 65), (240, 165, 272), (82, 165, 225),
            red)
    quadset((423, 0, 247), (265, 0, 296), (472, 0, 406), (314, 0, 456),
            (423, 330, 247), (265, 330, 296), (472, 330, 406), (314, 330, 456),
            blue)
    verts = np.array([[t[0], t[1], t[2]] for t in tris], dtype=np.float32)
    rgb = np.array([t[3] for t in tris], dtype=np.float32)
    mat = np.full((len(tris),), MAT_DIFFUSE, dtype=np.float32)
    verts = verts * np.float32(2.0 / L)
    verts = verts - np.float32(1.0)
    verts[..., 0] *= -1.0
    verts[..., 1] *= -1.0
    return verts, rgb, mat


def build(seed: int) -> dict:
    """The reference's Cornell box: 26 triangles, the glass sphere and the
    mirror sphere, the live kernel's light (16) and indirect term (0.5).
    The seed changes nothing."""
    del seed
    verts, rgb, mat = _cornell_triangles()
    f = np.float32
    return {
        "tri_v0": verts[:, 0].copy(), "tri_v1": verts[:, 1].copy(),
        "tri_v2": verts[:, 2].copy(), "tri_rgb": rgb, "tri_mat": mat,
        "sph_center": np.array([[0.3, 0.1, -0.5], [-0.4, 0.8, -0.5]], f),
        "sph_r2": np.array([0.075, 0.05], f),
        "sph_rgb": np.zeros((2, 3), f),
        "sph_mat": np.array([MAT_GLASS, MAT_MIRROR], f),
        "light_pos": np.array([0.0, -0.5, -0.7], f),
        "light_color": np.array([16.0, 16.0, 16.0], f),
        "indirect_light": np.array([0.5, 0.5, 0.5], f),
        "camera_pos": np.array([0.0, 0.0, -3.2], f),
        "yaw": np.array(0.0, f), "pitch": np.array(0.0, f),
    }
