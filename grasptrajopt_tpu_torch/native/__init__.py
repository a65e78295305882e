"""ctypes bindings for the port's geomcore library (csrc/geomcore.cpp).

Port of grasptrajopt_tpu/native/__init__.py. Builds on demand with g++ (no
pybind11) into `grasptrajopt_tpu_torch/_build/libgeomcore.so`:

    g++ -O3 -shared -fPIC -std=c++17 -pthread csrc/geomcore.cpp -o _build/libgeomcore.so

Every entry point has a pure-Python fallback elsewhere in the package
(`envs/render.py`'s numpy rasterizer, `models/mesh.py`'s loaders), so the
package works on a host without a compiler; the native path makes
host-side asset preparation and rendering faster. Nothing here runs at
import time.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_PACKAGE_DIR = Path(__file__).resolve().parents[1]
_SRC = _PACKAGE_DIR / "csrc" / "geomcore.cpp"
_LIB = _PACKAGE_DIR / "_build" / "libgeomcore.so"

_lib: Optional[ctypes.CDLL] = None
_tried = False


def build(force: bool = False) -> bool:
    """Compile libgeomcore.so with g++; returns success. Rebuilds when the
    source is newer than the library."""
    if (
        _LIB.exists()
        and not force
        and (not _SRC.exists() or _LIB.stat().st_mtime >= _SRC.stat().st_mtime)
    ):
        return True
    if not _SRC.exists():
        return False
    _LIB.parent.mkdir(parents=True, exist_ok=True)
    tmp = _LIB.with_name(f"{_LIB.name}.{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread", str(_SRC), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (subprocess.CalledProcessError, FileNotFoundError, subprocess.TimeoutExpired):
        return False
    os.replace(tmp, _LIB)  # atomic: a concurrent process never loads half a file
    return True


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not build():
        return None
    try:
        lib = ctypes.CDLL(str(_LIB))
    except OSError:
        return None
    lib.geom_load_obj.restype = ctypes.c_void_p
    lib.geom_load_obj.argtypes = [ctypes.c_char_p]
    lib.geom_load_stl.restype = ctypes.c_void_p
    lib.geom_load_stl.argtypes = [ctypes.c_char_p]
    lib.geom_mesh_num_vertices.restype = ctypes.c_int64
    lib.geom_mesh_num_vertices.argtypes = [ctypes.c_void_p]
    lib.geom_mesh_num_faces.restype = ctypes.c_int64
    lib.geom_mesh_num_faces.argtypes = [ctypes.c_void_p]
    lib.geom_mesh_copy.restype = None
    lib.geom_mesh_copy.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.geom_mesh_free.restype = None
    lib.geom_mesh_free.argtypes = [ctypes.c_void_p]
    lib.geom_kdtree_build.restype = ctypes.c_void_p
    lib.geom_kdtree_build.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.geom_kdtree_query.restype = None
    lib.geom_kdtree_query.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.geom_kdtree_free.restype = None
    lib.geom_kdtree_free.argtypes = [ctypes.c_void_p]
    lib.geom_rasterize.restype = None
    lib.geom_rasterize.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,  # verts_cam, n_verts
        ctypes.c_void_p, ctypes.c_int64,  # faces, n_faces
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,  # W, H, obj_id
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # depth, id, face
    ]
    _lib = lib
    return _lib


def is_available() -> bool:
    return _load() is not None


def load_mesh_native(path: str) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Load OBJ/STL via geomcore; returns (vertices, faces) or None."""
    lib = _load()
    if lib is None:
        return None
    ext = os.path.splitext(path)[1].lower()
    if ext == ".obj":
        handle = lib.geom_load_obj(path.encode())
    elif ext == ".stl":
        handle = lib.geom_load_stl(path.encode())
    else:
        return None
    if not handle:
        return None
    try:
        nv = lib.geom_mesh_num_vertices(handle)
        nf = lib.geom_mesh_num_faces(handle)
        vertices = np.empty((nv, 3), dtype=np.float64)
        faces = np.empty((nf, 3), dtype=np.int32)
        lib.geom_mesh_copy(
            handle,
            vertices.ctypes.data_as(ctypes.c_void_p),
            faces.ctypes.data_as(ctypes.c_void_p),
        )
        return vertices, faces
    finally:
        lib.geom_mesh_free(handle)


def _check_buffer(name: str, buf: np.ndarray, dtype, size: int) -> None:
    if buf.dtype != dtype or not buf.flags.c_contiguous or buf.size != size:
        raise ValueError(
            f"{name} must be a C-contiguous {np.dtype(dtype).name} buffer of {size} pixels, "
            f"got {buf.dtype} of {buf.size} (contiguous: {buf.flags.c_contiguous})"
        )


def rasterize_native(
    verts_cam: np.ndarray,
    faces: np.ndarray,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    width: int,
    height: int,
    obj_id: int,
    depth_buf: np.ndarray,
    id_buf: np.ndarray,
    face_buf: Optional[np.ndarray] = None,
) -> bool:
    """Z-buffer rasterize one camera-frame mesh into caller-owned buffers
    (geomcore geom_rasterize). Returns False when the native lib is absent
    (the caller falls back to envs/render.py's numpy path)."""
    lib = _load()
    if lib is None:
        return False
    v = np.ascontiguousarray(verts_cam, dtype=np.float64)
    f = np.ascontiguousarray(faces, dtype=np.int32)
    if v.ndim != 2 or v.shape[1] != 3 or f.ndim != 2 or f.shape[1] != 3:
        raise ValueError(f"vertices (n, 3) and faces (m, 3), got {v.shape} and {f.shape}")
    if f.size and (f.min() < 0 or f.max() >= v.shape[0]):
        raise ValueError(f"face indices outside [0, {v.shape[0]})")
    pixels = int(width) * int(height)
    _check_buffer("depth_buf", depth_buf, np.float32, pixels)
    _check_buffer("id_buf", id_buf, np.int32, pixels)
    fb = None
    if face_buf is not None:
        _check_buffer("face_buf", face_buf, np.int32, pixels)
        fb = face_buf.ctypes.data_as(ctypes.c_void_p)
    lib.geom_rasterize(
        v.ctypes.data_as(ctypes.c_void_p), v.shape[0],
        f.ctypes.data_as(ctypes.c_void_p), f.shape[0],
        float(fx), float(fy), float(cx), float(cy),
        int(width), int(height), int(obj_id),
        depth_buf.ctypes.data_as(ctypes.c_void_p),
        id_buf.ctypes.data_as(ctypes.c_void_p),
        fb,
    )
    return True


class NativeKDTree:
    """Nearest-neighbor queries backed by the C++ median-split KD-tree."""

    def __init__(self, points: np.ndarray):
        lib = _load()
        if lib is None:
            raise RuntimeError("geomcore native library unavailable")
        self._lib = lib
        self._points = np.ascontiguousarray(points, dtype=np.float64)
        if self._points.ndim != 2 or self._points.shape[1] != 3:
            raise ValueError(f"points must be (n, 3), got {self._points.shape}")
        self._handle = lib.geom_kdtree_build(
            self._points.ctypes.data_as(ctypes.c_void_p), self._points.shape[0]
        )

    def query(self, queries: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        q = np.ascontiguousarray(queries, dtype=np.float64)
        if q.ndim != 2 or q.shape[1] != 3:
            raise ValueError(f"queries must be (m, 3), got {q.shape}")
        m = q.shape[0]
        dists = np.empty(m, dtype=np.float64)
        idx = np.empty(m, dtype=np.int32)
        self._lib.geom_kdtree_query(
            self._handle,
            q.ctypes.data_as(ctypes.c_void_p),
            m,
            dists.ctypes.data_as(ctypes.c_void_p),
            idx.ctypes.data_as(ctypes.c_void_p),
        )
        return dists, idx

    def __del__(self):
        if getattr(self, "_handle", None) and self._lib is not None:
            self._lib.geom_kdtree_free(self._handle)
            self._handle = None
