"""Parallelogram (quad) merging of coplanar triangle pairs.

Port of ``raytpu/geometry/quads.py`` (``detect_quad_pairs``,
``leftover_indices``, ``classify_axis_aligned``): host numpy in float64,
run once at scene load, with the same greedy pairing order, so the tuples
equal ``raytpu``'s exactly. Block-world exports triangulate every
rectangular face into two coplanar triangles that share a diagonal; K3's
merged search (``kernels/trace_scene``) tests such a pair once, as a
parallelogram, and recovers the winning half from the diagonal side, so
the winner it records stays an original triangle index.

Detection is geometric and material-blind: two halves with different
materials still merge, and a hit inside the ~tri_eps crack the
per-triangle test leaves along the shared diagonal goes to half i (the
merged search accepts that crack). Its ranking by fractions also rounds
differently in the last bits, so the merged search agrees with the
per-triangle one to rounding and winner agreement, not bit for bit;
``merge_quads = false`` in a scene spec (or
``RenderConfig.merge_quads=False``) keeps the per-triangle search.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np


def _vertices(ax, ay, az, bx, by, bz, cx, cy, cz) -> np.ndarray:
    """(T, 3 vertices, 3 axes) float64 from per-triangle coordinate arrays
    (numpy arrays or CPU/CUDA tensors)."""
    f = lambda v: np.asarray(v.detach().cpu() if hasattr(v, "detach") else v,
                             np.float64)
    return np.stack([np.stack([f(ax), f(ay), f(az)], -1),
                     np.stack([f(bx), f(by), f(bz)], -1),
                     np.stack([f(cx), f(cy), f(cz)], -1)], axis=1)


def detect_quad_pairs(ax, ay, az, bx, by, bz, cx, cy, cz
                      ) -> tuple[tuple[int, int, int], ...]:
    """Disjoint triangle pairs that form parallelograms, as sorted
    ``(i, j, oi)``: triangles i and j share an edge that is the
    parallelogram's diagonal, and ``oi`` (0..2) is triangle i's vertex
    opposite that edge. A pair needs exact closure in float64
    (``opp_i + opp_j == s1 + s2``: the rectangle spans exactly the two
    halves) and consistent winding (``n_i . n_j > 0``: the search culls
    back faces, so halves facing opposite ways must not merge). Pairing is
    greedy per shared edge, each triangle in at most one pair."""
    V = _vertices(ax, ay, az, bx, by, bz, cx, cy, cz)
    n_tris = V.shape[0]
    normals = np.cross(V[:, 1] - V[:, 0], V[:, 2] - V[:, 0])

    edges: dict = defaultdict(list)
    for i in range(n_tris):
        vs = [tuple(V[i, k]) for k in range(3)]
        for e in range(3):
            v1, v2 = vs[(e + 1) % 3], vs[(e + 2) % 3]
            edges[(min(v1, v2), max(v1, v2))].append((i, e))   # e: opposite slot

    used = np.zeros(n_tris, bool)
    pairs = []
    for (s1, s2), lst in edges.items():
        if len(lst) < 2:
            continue
        mid2 = np.asarray(s1) + np.asarray(s2)
        for x in range(len(lst)):
            i, oi = lst[x]
            if used[i]:
                continue
            for y in range(x + 1, len(lst)):
                j, oj = lst[y]
                if used[j] or j == i:
                    continue
                if not np.array_equal(V[i, oi] + V[j, oj], mid2):
                    continue
                if float(np.dot(normals[i], normals[j])) <= 0.0:
                    continue
                used[i] = used[j] = True
                pairs.append((i, j, oi))
                break
    return tuple(sorted(pairs))


def leftover_indices(n_tris: int, pairs) -> tuple[int, ...]:
    """Triangle indices in no pair, in their order."""
    used = {t for i, j, _ in pairs for t in (i, j)}
    return tuple(k for k in range(n_tris) if k not in used)


def classify_axis_aligned(ax, ay, az, bx, by, bz, cx, cy, cz, pairs
                          ) -> tuple[tuple, tuple]:
    """``(rect_classes, tri_classes)`` for the merged search's
    axis-aligned loops.

    ``rect_classes`` is parallel to ``pairs``: ``()`` for a general
    parallelogram, or ``(k, s, m)`` for an axis-aligned rectangle whose
    normal lies along axis k with sign s (+-1) and whose edge e1 lies
    along in-plane slot m (0: the lower-numbered in-plane axis, 1: the
    higher); axis-aligned means the normal and both edges each have
    exactly one non-zero component. ``tri_classes`` lists
    ``(tri_index, k, s)`` for the unpaired triangles whose normal is
    axis-aligned (their edges are arbitrary in the plane)."""
    V = _vertices(ax, ay, az, bx, by, bz, cx, cy, cz)
    rect_classes = []
    for (i, j, oi) in pairs:
        a = V[i, oi]
        e1 = V[i, (oi + 1) % 3] - a
        e2 = V[i, (oi + 2) % 3] - a
        n = np.cross(e1, e2)
        nz = np.nonzero(n)[0]
        if len(nz) == 1 and np.count_nonzero(e1) == 1 and np.count_nonzero(e2) == 1:
            k = int(nz[0])
            s = 1 if n[k] > 0 else -1
            i1 = [a_ for a_ in range(3) if a_ != k][0]
            rect_classes.append((k, s, 0 if e1[i1] != 0 else 1))
        else:
            rect_classes.append(())
    tri_classes = []
    for t in leftover_indices(V.shape[0], pairs):
        n = np.cross(V[t, 1] - V[t, 0], V[t, 2] - V[t, 0])
        nz = np.nonzero(n)[0]
        if len(nz) == 1:
            tri_classes.append((t, int(nz[0]), 1 if n[nz[0]] > 0 else -1))
    return tuple(rect_classes), tuple(tri_classes)
