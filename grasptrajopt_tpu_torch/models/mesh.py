"""Triangle-mesh IO and surface sampling (host-side asset prep).

First-party replacement for the trimesh + pyrender virtual-scan pipeline the
reference uses to build per-link surface point clouds
(mesh_to_sdf/surface_point_cloud.py:177-188 `sample_from_mesh`
— the 'sample' path is the one the planners actually use,
gto/gto_models.py:76). We load OBJ/STL directly with stdlib + numpy and
sample points area-weighted on the triangle surface with a deterministic RNG,
returning points + face normals.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


@dataclass
class TriangleMesh:
    vertices: np.ndarray  # (V, 3) float64
    faces: np.ndarray  # (T, 3) int32

    @property
    def face_normals(self) -> np.ndarray:
        v = self.vertices
        f = self.faces
        n = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
        norms = np.linalg.norm(n, axis=1, keepdims=True)
        return n / np.maximum(norms, 1e-12)

    @property
    def face_areas(self) -> np.ndarray:
        v = self.vertices
        f = self.faces
        n = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
        return 0.5 * np.linalg.norm(n, axis=1)

    @property
    def bounding_radius(self) -> float:
        return float(np.linalg.norm(self.vertices, axis=1).max(initial=0.0))

    def scaled(self, scale) -> "TriangleMesh":
        scale = np.asarray(scale, dtype=np.float64)
        return TriangleMesh(vertices=self.vertices * scale, faces=self.faces)

    def sample_surface(
        self, count: int, seed: int = 0, with_normals: bool = True
    ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Area-weighted random points on the surface (deterministic).

        Matches the semantics of trimesh.sample.sample_surface as used by the
        reference (mesh.sample + per-sample face normals,
        mesh_to_sdf/surface_point_cloud.py:177-188).
        """
        rng = np.random.default_rng(seed)
        areas = self.face_areas
        total = areas.sum()
        if total <= 0 or len(self.faces) == 0:
            raise ValueError("mesh has no area to sample")
        probs = areas / total
        face_idx = rng.choice(len(self.faces), size=count, p=probs)
        # Uniform barycentric sampling via sqrt trick.
        r1 = np.sqrt(rng.random(count))
        r2 = rng.random(count)
        a = 1.0 - r1
        b = r1 * (1.0 - r2)
        c = r1 * r2
        tri = self.vertices[self.faces[face_idx]]  # (count, 3, 3)
        pts = a[:, None] * tri[:, 0] + b[:, None] * tri[:, 1] + c[:, None] * tri[:, 2]
        normals = self.face_normals[face_idx] if with_normals else None
        return pts, normals


def load_obj(path: str) -> TriangleMesh:
    """Wavefront OBJ loader: v/f records, fan-triangulates polygons."""
    vertices = []
    faces = []
    with open(path, "r", errors="replace") as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                vertices.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("f "):
                idx = []
                for tok in line.split()[1:]:
                    vi = tok.split("/")[0]
                    i = int(vi)
                    idx.append(i - 1 if i > 0 else len(vertices) + i)
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    if not vertices:
        raise ValueError(f"no vertices in OBJ file {path}")
    return TriangleMesh(
        vertices=np.asarray(vertices, dtype=np.float64),
        faces=np.asarray(faces, dtype=np.int32).reshape(-1, 3),
    )


def load_stl(path: str) -> TriangleMesh:
    """STL loader handling both binary and ASCII variants."""
    with open(path, "rb") as f:
        head = f.read(5)
        f.seek(0)
        data = f.read()
    if head.lower() == b"solid":
        # Might still be binary with a 'solid' header; sanity-check size.
        try:
            return _load_stl_ascii(data.decode("ascii", errors="strict"))
        except (UnicodeDecodeError, ValueError):
            pass
    return _load_stl_binary(data, path)


def _load_stl_binary(data: bytes, path: str) -> TriangleMesh:
    if len(data) < 84:
        raise ValueError(f"truncated binary STL {path}")
    (n_tri,) = struct.unpack_from("<I", data, 80)
    expected = 84 + n_tri * 50
    if len(data) < expected:
        raise ValueError(f"binary STL {path} size mismatch: {len(data)} < {expected}")
    rec = np.frombuffer(data, dtype=np.uint8, count=n_tri * 50, offset=84).reshape(n_tri, 50)
    tri = rec[:, 12:48].copy().view("<f4").reshape(n_tri, 3, 3).astype(np.float64)
    vertices = tri.reshape(-1, 3)
    faces = np.arange(n_tri * 3, dtype=np.int32).reshape(-1, 3)
    return TriangleMesh(vertices=vertices, faces=faces)


def _load_stl_ascii(text: str) -> TriangleMesh:
    vertices = []
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("vertex"):
            parts = line.split()
            vertices.append([float(parts[1]), float(parts[2]), float(parts[3])])
    if not vertices or len(vertices) % 3 != 0:
        raise ValueError("malformed ASCII STL")
    vertices = np.asarray(vertices, dtype=np.float64)
    faces = np.arange(len(vertices), dtype=np.int32).reshape(-1, 3)
    return TriangleMesh(vertices=vertices, faces=faces)


def box_mesh(size) -> TriangleMesh:
    """Axis-aligned box centered at the origin (URDF <box size=...>)."""
    hx, hy, hz = (float(s) / 2.0 for s in size)
    v = np.array(
        [[x, y, z] for x in (-hx, hx) for y in (-hy, hy) for z in (-hz, hz)]
    )
    quads = [
        (0, 1, 3, 2), (4, 6, 7, 5),
        (0, 4, 5, 1), (2, 3, 7, 6),
        (0, 2, 6, 4), (1, 5, 7, 3),
    ]
    faces = []
    for a, b, c, d in quads:
        faces += [[a, b, c], [a, c, d]]
    return TriangleMesh(vertices=v, faces=np.asarray(faces, dtype=np.int32))


def cylinder_mesh(radius: float, length: float, segments: int = 24) -> TriangleMesh:
    """Z-axis cylinder centered at the origin (URDF convention)."""
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
        # side quad
        faces += [[i, segments + i, segments + j], [i, segments + j, j]]
        # caps
        faces += [[ci_top, i, j], [ci_bot, segments + j, segments + i]]
    return TriangleMesh(vertices=verts, faces=np.asarray(faces, dtype=np.int32))


def sphere_mesh(radius: float, subdiv: int = 2) -> TriangleMesh:
    """Icosphere of the given radius."""
    t = (1.0 + 5**0.5) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        dtype=float,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ]
    )
    for _ in range(subdiv):
        verts_list = list(verts)
        cache = {}
        new_faces = []
        for a, b, c in faces:
            mids = []
            for i, j in ((a, b), (b, c), (c, a)):
                key = (min(i, j), max(i, j))
                if key not in cache:
                    m = (verts_list[i] + verts_list[j]) / 2
                    cache[key] = len(verts_list)
                    verts_list.append(m / np.linalg.norm(m))
                mids.append(cache[key])
            ab, bc, ca = mids
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.asarray(verts_list)
        faces = np.asarray(new_faces)
    return TriangleMesh(vertices=verts * radius, faces=faces.astype(np.int32))


def geometry_mesh(geom, model_dir: str = "") -> Optional[TriangleMesh]:
    """Mesh for a UrdfGeometry: file mesh (scaled) or analytic primitive."""
    if geom.mesh_filename is not None:
        mesh = load_mesh(os.path.join(model_dir, geom.mesh_filename))
        if any(abs(s - 1.0) > 1e-12 for s in geom.mesh_scale):
            mesh = mesh.scaled(geom.mesh_scale)
        return mesh
    if geom.box_size is not None:
        return box_mesh(geom.box_size)
    if geom.cylinder_radius is not None:
        return cylinder_mesh(geom.cylinder_radius, geom.cylinder_length or 0.0)
    if geom.sphere_radius is not None:
        return sphere_mesh(geom.sphere_radius)
    return None


def load_dae(path: str) -> TriangleMesh:
    """Minimal COLLADA (.dae) triangle loader: concatenates every
    <triangles>/<polylist> primitive in library_geometries using the
    position source; materials, normals, and scene-node transforms are
    ignored (adequate for single-link visual meshes, the only DAE use in
    the supported robot assets — nextage, r2d2, fetch extras)."""
    import xml.etree.ElementTree as ET

    ns = {"c": "http://www.collada.org/2005/11/COLLADASchema"}
    root = ET.parse(path).getroot()

    all_vertices = []
    all_faces = []
    offset = 0
    for geom in root.findall(".//c:library_geometries/c:geometry", ns):
        mesh = geom.find("c:mesh", ns)
        if mesh is None:
            continue
        # map source id -> float array
        sources = {}
        for src in mesh.findall("c:source", ns):
            arr = src.find("c:float_array", ns)
            if arr is not None and arr.text:
                sources["#" + src.get("id")] = np.fromstring(arr.text, sep=" ")
        # vertices element: position input
        vert_elem = mesh.find("c:vertices", ns)
        if vert_elem is None:
            continue
        pos_source = None
        for inp in vert_elem.findall("c:input", ns):
            if inp.get("semantic") == "POSITION":
                pos_source = inp.get("source")
        if pos_source is None or pos_source not in sources:
            continue
        verts = sources[pos_source].reshape(-1, 3)
        vert_id = "#" + vert_elem.get("id")

        for prim in list(mesh.findall("c:triangles", ns)) + list(mesh.findall("c:polylist", ns)):
            inputs = prim.findall("c:input", ns)
            stride = max(int(i.get("offset", 0)) for i in inputs) + 1 if inputs else 1
            v_off = 0
            for i in inputs:
                if i.get("semantic") == "VERTEX" and i.get("source") == vert_id:
                    v_off = int(i.get("offset", 0))
            p = prim.find("c:p", ns)
            if p is None or not p.text:
                continue
            idx = np.fromstring(p.text, sep=" ", dtype=np.int64)
            vcounts_elem = prim.find("c:vcount", ns)
            if vcounts_elem is not None and vcounts_elem.text:
                # polylist: fan-triangulate each polygon
                vcounts = np.fromstring(vcounts_elem.text, sep=" ", dtype=np.int64)
                pos = 0
                for n in vcounts:
                    poly = idx[pos + v_off : pos + n * stride : stride]
                    for k in range(1, n - 1):
                        all_faces.append(
                            [offset + poly[0], offset + poly[k], offset + poly[k + 1]]
                        )
                    pos += n * stride
            else:
                tri = idx[v_off::stride].reshape(-1, 3)
                all_faces.extend((tri + offset).tolist())
        all_vertices.append(verts)
        offset += verts.shape[0]

    if not all_vertices:
        raise ValueError(f"no geometry found in DAE file {path}")
    return TriangleMesh(
        vertices=np.concatenate(all_vertices),
        faces=np.asarray(all_faces, dtype=np.int32).reshape(-1, 3),
    )


def load_mesh(path: str, prefer_native: bool = True) -> TriangleMesh:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".dae":
        return load_dae(path)
    if ext not in (".obj", ".stl"):
        raise ValueError(f"unsupported mesh format '{ext}' ({path})")
    if prefer_native:
        # geomcore C++ loader (grasptrajopt_tpu_torch.native); bit-identical
        # output, ~10x faster parsing for large OBJ files; None where the
        # library cannot be built or the file does not parse
        from grasptrajopt_tpu_torch import native

        result = native.load_mesh_native(path)
        if result is not None:
            return TriangleMesh(vertices=result[0], faces=result[1])
    return load_obj(path) if ext == ".obj" else load_stl(path)
