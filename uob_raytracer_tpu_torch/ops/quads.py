"""Shadow-geometry quad merging: pair coplanar triangles into parallelograms
for the occlusion scan. A copy of ``uob_raytracer_tpu/ops/quads.py`` (it is
numpy-only); the one change is that scene leaves are torch tensors, read to
the host with ``_host`` wherever they live.

The Cornell scene's 26 triangles (``Source/TestModelH.h:87-189``) are 13
exact parallelogram halves: every wall and block face is a rectangle split
along its diagonal. The soft-shadow pass only needs a boolean "does anything
occlude this sample ray", and the union of two triangles that tile a
parallelogram *is* that parallelogram, tested with the same Cramer dot
products but with independent bounds (0 <= u <= 1, 0 <= v <= 1) instead of
the triangle's simplex bound (u + v <= 1) (``kernels.cl:243-311`` is the
per-triangle reference semantics). One quad row therefore replaces two
triangle rows in the occlusion scan, halving its cost on quad-heavy scenes.

Exactness: in real arithmetic the quad test accepts exactly the rays the
two-triangle union accepts (given the parallelogram closure
v3 = s1 + s2 - p). In f32 the two formulations can disagree for sample rays
within rounding distance of the shared diagonal or of the closure residual
(detection enforces |v3 - (s1+s2-p)| <= tol); those flip at most one of the
pixel's shadow samples — inside the framework's documented boundary-pixel
parity budget (PARITY.md). The nearest-hit passes (primary, bounces) keep
exact per-triangle identity.

Detection runs on the scene's current values and returns a hashable static
structure. Geometry that is being optimized should not reuse a pairing
detected before the vertices moved: ``validate_shadow_quads`` catches that.
"""
from __future__ import annotations

import numpy as np

# Pairing: ((tri_a, corner_of_p, tri_b), ...), (leftover_tri_ids, ...)
ShadowQuads = tuple


def _host(leaf) -> np.ndarray:
    """A scene leaf as a float32 numpy array (copied from the card if it
    lives there)."""
    return leaf.detach().cpu().numpy().astype(np.float32)


def _verify_pair(verts, is_glass, eps, a, b):
    """Precise pairing test for candidate (a, b): same glass status, exactly
    two shared vertices (within eps), parallelogram closure (within eps).
    Returns triangle a's off-diagonal corner index, or None."""
    if is_glass[a] != is_glass[b]:
        return None
    matches = [(i, j) for i in range(3) for j in range(3)
               if np.max(np.abs(verts[a, i] - verts[b, j])) <= eps]
    if len(matches) != 2:
        return None
    ai = {i for i, _ in matches}
    bj = {j for _, j in matches}
    if len(ai) != 2 or len(bj) != 2:
        return None
    p_i = ({0, 1, 2} - ai).pop()
    q_j = ({0, 1, 2} - bj).pop()
    s1_i, s2_i = sorted(ai)
    closure = (verts[a, s1_i] + verts[a, s2_i] - verts[a, p_i])
    if np.max(np.abs(closure - verts[b, q_j])) <= eps:
        return p_i
    return None


def detect_shadow_quads(scene, tol: float = 1e-6,
                        max_triangles: int = 65536) -> ShadowQuads | None:
    """Pair triangles (i, j) that tile a parallelogram and may be merged in
    the occlusion scan. Returns ``(pairs, leftover)`` where each pair is
    ``(tri_a, corner, tri_b)`` — the quad is spanned from triangle a's
    ``corner`` vertex p by its two other vertices — and ``leftover`` lists
    unpaired triangle ids. None when nothing pairs (or the scene is too
    large to scan).

    Conditions: the two triangles share exactly two vertices (within tol),
    the off-diagonal vertices satisfy the parallelogram closure
    q = s1 + s2 - p (within tol — this also forces coplanarity), and both
    have the same glass/non-glass status (the occlusion scan skips glass:
    ``kernels.cl:247,279``).

    Complexity: small scenes (<= 512 triangles) use the exhaustive
    tolerance-robust O(T^2) scan; larger (streamed-kernel) scenes use an
    O(T) shared-edge hash over byte-exact vertex keys — triangulated quad
    meshes share their diagonal vertices exactly, and every candidate is
    still verified with the precise epsilon tests, so the hash can only
    miss borderline pairs, never admit a wrong one.
    """
    v0, v1, v2 = _host(scene.tri_v0), _host(scene.tri_v1), _host(scene.tri_v2)
    mat = _host(scene.tri_mat)
    T = v0.shape[0]
    if T < 2 or T > max_triangles:
        return None
    verts = np.stack([v0, v1, v2], axis=1)  # [T, 3, 3]
    is_glass = mat == -1.0
    scale = max(1.0, float(np.max(np.abs(verts))))
    eps = tol * scale

    used = np.zeros(T, bool)
    pairs = []
    if T <= 512:
        for a in range(T):
            if used[a]:
                continue
            for b in range(a + 1, T):
                if used[b]:
                    continue
                p_i = _verify_pair(verts, is_glass, eps, a, b)
                if p_i is not None:
                    pairs.append((a, p_i, b))
                    used[a] = used[b] = True
                    break
    else:
        edges: dict = {}
        for t in range(T):
            keys = [verts[t, c].tobytes() for c in range(3)]
            for c in range(3):
                i, j = [x for x in range(3) if x != c]
                ek = (min(keys[i], keys[j]), max(keys[i], keys[j]))
                edges.setdefault(ek, []).append(t)
        for cands in edges.values():
            if len(cands) < 2:
                continue
            for x in range(len(cands)):
                a = cands[x]
                if used[a]:
                    continue
                for y in range(x + 1, len(cands)):
                    b = cands[y]
                    if used[b]:
                        continue
                    p_i = _verify_pair(verts, is_glass, eps, a, b)
                    if p_i is not None:
                        pairs.append((int(a), p_i, int(b)))
                        used[a] = used[b] = True
                        break
    if not pairs:
        return None
    leftover = tuple(int(i) for i in range(T) if not used[i])
    return (tuple(pairs), leftover)


def validate_shadow_quads(scene, quads, tol: float = 1e-6) -> None:
    """Check a pairing against the scene's *current* vertices.

    A pairing detected on one geometry silently corrupts shadows if reused
    after the vertices move (the merged parallelogram no longer covers the
    two triangles). This re-checks, for every pair, the shared-vertex and
    parallelogram-closure conditions of ``detect_shadow_quads`` plus the
    id partition (every triangle appears exactly once across pairs +
    leftover). Raises ValueError on any violation; no-op for quads=None."""
    if quads is None:
        return
    v0, v1, v2 = _host(scene.tri_v0), _host(scene.tri_v1), _host(scene.tri_v2)
    mat = _host(scene.tri_mat)
    verts = np.stack([v0, v1, v2], axis=1)
    T = verts.shape[0]
    pairs, leftover = quads
    seen = list(leftover)
    scale = max(1.0, float(np.max(np.abs(verts)))) if T else 1.0
    eps = tol * scale
    for a, p_i, b in pairs:
        seen += [a, b]
        if not (0 <= a < T and 0 <= b < T):
            raise ValueError(f"shadow-quad pairing references triangle "
                             f"({a},{b}) outside the scene's {T} triangles")
        if (mat[a] == -1.0) != (mat[b] == -1.0):
            raise ValueError(f"shadow-quad pair ({a},{b}) mixes glass and "
                             f"non-glass (occlusion skips glass)")
        s1_i, s2_i = [i for i in range(3) if i != p_i]
        # the two spanning vertices must still coincide with vertices of b
        for s_i in (s1_i, s2_i):
            if np.min(np.max(np.abs(verts[b] - verts[a, s_i]), axis=1)) > eps:
                raise ValueError(
                    f"stale shadow-quad pairing: triangles ({a},{b}) no "
                    f"longer share vertex {s_i} of {a} (moved geometry?) — "
                    f"re-run detect_shadow_quads on the current scene")
        closure = verts[a, s1_i] + verts[a, s2_i] - verts[a, p_i]
        if np.min(np.max(np.abs(verts[b] - closure), axis=1)) > eps:
            raise ValueError(
                f"stale shadow-quad pairing: pair ({a},{b}) violates the "
                f"parallelogram closure by more than {eps:g} — re-run "
                f"detect_shadow_quads on the current scene")
    if sorted(seen) != list(range(T)):
        raise ValueError("shadow-quad pairing does not partition the "
                         "triangle ids (pairs + leftover must cover each "
                         "triangle exactly once)")
