"""Triangle meshes of URDF primitives and their area-weighted surface
sampling: a frozen copy of the parts of `grasptrajopt_tpu_torch/models/mesh.py`
that the synth7 arm's surface points use."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


@dataclass
class TriangleMesh:
    vertices: np.ndarray  # (V, 3) float64
    faces: np.ndarray  # (T, 3) int32

    @property
    def face_normals(self) -> np.ndarray:
        v, f = self.vertices, self.faces
        n = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
        return n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-12)

    @property
    def face_areas(self) -> np.ndarray:
        v, f = self.vertices, self.faces
        return 0.5 * np.linalg.norm(np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]]), axis=1)

    def sample_surface(self, count: int, seed: int = 0) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Area-weighted random points on the surface (deterministic in
        `seed`) and the face normal of each."""
        rng = np.random.default_rng(seed)
        areas = self.face_areas
        probs = areas / areas.sum()
        face_idx = rng.choice(len(self.faces), size=count, p=probs)
        r1 = np.sqrt(rng.random(count))
        r2 = rng.random(count)
        a, b, c = 1.0 - r1, r1 * (1.0 - r2), r1 * r2
        tri = self.vertices[self.faces[face_idx]]
        pts = a[:, None] * tri[:, 0] + b[:, None] * tri[:, 1] + c[:, None] * tri[:, 2]
        return pts, self.face_normals[face_idx]


def box_mesh(size) -> TriangleMesh:
    """Axis-aligned box centred at the origin (URDF <box size=...>)."""
    hx, hy, hz = (float(s) / 2.0 for s in size)
    v = np.array([[x, y, z] for x in (-hx, hx) for y in (-hy, hy) for z in (-hz, hz)])
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3)]
    faces = []
    for a, b, c, d in quads:
        faces += [[a, b, c], [a, c, d]]
    return TriangleMesh(vertices=v, faces=np.asarray(faces, dtype=np.int32))


def cylinder_mesh(radius: float, length: float, segments: int = 24) -> TriangleMesh:
    """Z-axis cylinder centred at the origin (URDF convention)."""
    ang = np.linspace(0, 2 * np.pi, segments, endpoint=False)
    ring = np.stack([radius * np.cos(ang), radius * np.sin(ang)], axis=1)
    top = np.concatenate([ring, np.full((segments, 1), length / 2)], axis=1)
    bot = np.concatenate([ring, np.full((segments, 1), -length / 2)], axis=1)
    centers = np.array([[0, 0, length / 2], [0, 0, -length / 2]])
    verts = np.concatenate([top, bot, centers])
    ci_top, ci_bot = 2 * segments, 2 * segments + 1
    faces = []
    for i in range(segments):
        j = (i + 1) % segments
        faces += [[i, segments + i, segments + j], [i, segments + j, j]]
        faces += [[ci_top, i, j], [ci_bot, segments + j, segments + i]]
    return TriangleMesh(vertices=verts, faces=np.asarray(faces, dtype=np.int32))
