"""Software depth camera: z-buffer rendering of triangle-mesh scenes.

This is the framework's replacement for the reference's two GPU renderers:
PyBullet's `getCameraImage` scene observation
(examples/pybullet_scenereplica.py:465-495) and the
pyrender/OpenGL virtual-scan renderer of mesh_to_sdf
(mesh_to_sdf/pyrender_wrapper.py, scan.py:49-87). Output is
a metric depth image plus a per-pixel object-id mask (the segmentation the
drivers use to build the target-free obstacle field) and optionally a
per-pixel triangle index (for surface normals in the virtual-scan path).

Camera model matches fields/depth_point_cloud.py's backprojection: pinhole
K, camera looks down +z with x right / y down, `cam_pose` is
world-from-camera; depth values are camera-frame z. The hot loop is the
C++ rasterizer of csrc/geomcore.cpp (`grasptrajopt_tpu_torch.native`); a
vectorized numpy fallback renders the same pixels where the library
cannot be built.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from grasptrajopt_tpu_torch.models.mesh import TriangleMesh

FAR_DEPTH = np.float32(np.inf)


def _rasterize_numpy(
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
) -> None:
    """Per-triangle bbox rasterization; same semantics as geom_rasterize
    (pixel-center sampling, screen-linear 1/z, no backface culling)."""
    znear = 1e-6
    tri = verts_cam[faces]  # (F, 3, 3)
    z = tri[:, :, 2]
    valid = (z > znear).all(axis=1)
    w = np.where(z > znear, 1.0 / np.maximum(z, znear), 0.0)  # (F, 3)
    x = fx * tri[:, :, 0] * w + cx
    y = fy * tri[:, :, 1] * w + cy
    for f in np.nonzero(valid)[0]:
        xs, ys, ws = x[f], y[f], w[f]
        x0 = max(int(np.floor(xs.min())), 0)
        x1 = min(int(np.ceil(xs.max())), width - 1)
        y0 = max(int(np.floor(ys.min())), 0)
        y1 = min(int(np.ceil(ys.max())), height - 1)
        if x0 > x1 or y0 > y1:
            continue
        ax, ay = xs[1] - xs[0], ys[1] - ys[0]
        bx, by = xs[2] - xs[0], ys[2] - ys[0]
        area = ax * by - ay * bx
        if abs(area) < 1e-12:
            continue
        uu, vv = np.meshgrid(
            np.arange(x0, x1 + 1) + 0.5, np.arange(y0, y1 + 1) + 0.5
        )
        dx = uu - xs[0]
        dy = vv - ys[0]
        b1 = (dx * by - dy * bx) / area
        b2 = (ax * dy - ay * dx) / area
        b0 = 1.0 - b1 - b2
        wi = b0 * ws[0] + b1 * ws[1] + b2 * ws[2]
        inside = (b0 >= 0) & (b1 >= 0) & (b2 >= 0) & (wi > 0)
        if not inside.any():
            continue
        zi = np.where(inside, 1.0 / np.where(wi > 0, wi, 1.0), np.inf).astype(np.float32)
        patch = depth_buf[y0 : y1 + 1, x0 : x1 + 1]
        closer = zi < patch
        patch[closer] = zi[closer]
        id_buf[y0 : y1 + 1, x0 : x1 + 1][closer] = obj_id
        if face_buf is not None:
            face_buf[y0 : y1 + 1, x0 : x1 + 1][closer] = f


def render_depth(
    meshes: Sequence[Tuple[TriangleMesh, np.ndarray, int]],
    cam_pose: np.ndarray,
    K: np.ndarray,
    width: int,
    height: int,
    background_depth: float = 0.0,
    with_faces: bool = False,
    znear: float = 0.0,
):
    """Render a posed mesh list into (depth, id_mask[, face_idx]).

    meshes: sequence of (mesh, world_from_model 4x4 pose, object id).
    Pixels hit by no surface get `background_depth` (0 = invalid, the
    DepthPointCloud convention) and id -1. With `with_faces`, also returns
    the per-pixel (object-local) triangle index (-1 where empty).

    `znear` > 0 culls triangles with any vertex nearer than the plane
    (conservative GL-style near clipping — geometry hugging the camera,
    e.g. the mesh of the link the camera is mounted on, would otherwise
    z-buffer the whole image away). Note per-pixel face indices keep the
    ORIGINAL face numbering.
    """
    from grasptrajopt_tpu_torch.native import rasterize_native

    cam_pose = np.asarray(cam_pose, dtype=np.float64)
    K = np.asarray(K, dtype=np.float64)
    R_wc = cam_pose[:3, :3]
    t_wc = cam_pose[:3, 3]
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]

    depth = np.full((height, width), FAR_DEPTH, dtype=np.float32)
    ids = np.full((height, width), -1, dtype=np.int32)
    face_idx = np.full((height, width), -1, dtype=np.int32) if with_faces else None

    for mesh, pose, obj_id in meshes:
        pose = np.asarray(pose, dtype=np.float64)
        verts_world = mesh.vertices @ pose[:3, :3].T + pose[:3, 3]
        verts_cam = (verts_world - t_wc) @ R_wc
        faces = mesh.faces
        kept = None
        if znear > 0.0:
            keep = verts_cam[faces][:, :, 2].min(axis=1) >= znear
            if not keep.all():
                kept = np.nonzero(keep)[0].astype(np.int32)
                faces = np.ascontiguousarray(faces[keep])
        # Pixels of an EARLIER mesh may share this obj_id (multi-link bodies
        # render every link under the body uid), so "mine" below must be
        # limited to pixels this pass actually wrote — snapshot the z-buffer.
        depth_before = (
            depth.copy() if (kept is not None and face_idx is not None) else None
        )
        done = rasterize_native(
            verts_cam, faces, fx, fy, cx, cy, width, height,
            obj_id, depth, ids, face_idx,
        )
        if not done:
            _rasterize_numpy(
                verts_cam, faces, fx, fy, cx, cy, width, height,
                obj_id, depth, ids, face_idx,
            )
        if kept is not None and face_idx is not None:
            # restore ORIGINAL face numbering for the pixels THIS pass wrote
            mine = (depth < depth_before) & (face_idx >= 0)
            face_idx[mine] = kept[face_idx[mine]]

    empty = ~np.isfinite(depth)
    depth[empty] = background_depth
    if with_faces:
        return depth, ids, face_idx
    return depth, ids


def look_at_pose(eye, target, up=(0.0, 0.0, 1.0)) -> np.ndarray:
    """World-from-camera pose with +z looking from `eye` toward `target`
    (x right, y down — the depth-camera frame of this module)."""
    eye = np.asarray(eye, dtype=np.float64)
    fwd = np.asarray(target, dtype=np.float64) - eye
    fwd = fwd / max(np.linalg.norm(fwd), 1e-12)
    up = np.asarray(up, dtype=np.float64)
    right = np.cross(fwd, up)
    n = np.linalg.norm(right)
    if n < 1e-9:  # looking along up: pick any perpendicular
        right = np.cross(fwd, [1.0, 0.0, 0.0])
        n = np.linalg.norm(right)
        if n < 1e-9:
            right = np.cross(fwd, [0.0, 1.0, 0.0])
            n = np.linalg.norm(right)
    right /= n
    down = np.cross(fwd, right)
    pose = np.eye(4)
    pose[:3, 0] = right
    pose[:3, 1] = down
    pose[:3, 2] = fwd
    pose[:3, 3] = eye
    return pose
