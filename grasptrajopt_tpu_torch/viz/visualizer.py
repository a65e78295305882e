"""Matplotlib 3D visualizer.

Port of grasptrajopt_tpu/viz/visualizer.py: the same API and artists; the
robot's frames come from the port's `fk_all`, copied to the host once a
call. Host-only: matplotlib is imported when a Visualizer is built.

API parity targets (the reference's optas/visualize.py): line(:286),
points(:335), sphere(:364), box(:479), cylinder(:528), text(:622),
grid_floor(:744), obj/stl(:852,:902), robot(:958-1170) rendering URDF
visuals via per-link FK, robot_traj(:1171) ghost trajectories with alpha
ramp styles, save(:1274) screenshots, start(:1303) interactive display.

Meshes render as decimated triangle collections; robots without visual
meshes fall back to skeleton line rendering between link origins.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


class Visualizer:
    def __init__(
        self,
        camera_position: Sequence[float] = (2.0, 2.0, 2.0),
        camera_focal_point: Sequence[float] = (0.0, 0.0, 0.0),
        window_size: Sequence[int] = (800, 600),
        background_color: str = "white",
    ):
        import matplotlib

        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt  # noqa: F401

        self._plt = plt
        self.fig = plt.figure(figsize=(window_size[0] / 100, window_size[1] / 100))
        self.ax = self.fig.add_subplot(projection="3d")
        self.ax.set_facecolor(background_color)
        cam = np.asarray(camera_position, dtype=float)
        focal = np.asarray(camera_focal_point, dtype=float)
        d = cam - focal
        r = np.linalg.norm(d)
        self.ax.view_init(
            elev=float(np.degrees(np.arcsin(d[2] / max(r, 1e-9)))),
            azim=float(np.degrees(np.arctan2(d[1], d[0]))),
        )
        self._bounds = []

    # -- primitives -----------------------------------------------------------

    def _track(self, pts: np.ndarray) -> None:
        self._bounds.append(np.asarray(pts).reshape(-1, 3))

    def points(self, points, rgb=(1, 0, 0), size: float = 3.0, alpha: float = 1.0):
        points = np.asarray(points)
        self.ax.scatter(points[:, 0], points[:, 1], points[:, 2], color=tuple(rgb), s=size, alpha=alpha)
        self._track(points)

    def line(self, start, end, rgb=(0, 0, 1), width: float = 1.0, alpha: float = 1.0):
        seg = np.stack([np.asarray(start), np.asarray(end)])
        self.ax.plot(seg[:, 0], seg[:, 1], seg[:, 2], color=tuple(rgb), linewidth=width, alpha=alpha)
        self._track(seg)

    def sphere(self, radius: float = 1.0, position=(0, 0, 0), rgb=(0, 1, 0), alpha: float = 1.0):
        u, v = np.mgrid[0 : 2 * np.pi : 16j, 0 : np.pi : 8j]
        x = radius * np.cos(u) * np.sin(v) + position[0]
        y = radius * np.sin(u) * np.sin(v) + position[1]
        z = radius * np.cos(v) + position[2]
        self.ax.plot_surface(x, y, z, color=tuple(rgb), alpha=alpha, linewidth=0)
        self._track(np.stack([x.ravel(), y.ravel(), z.ravel()], axis=1))

    def box(self, half_extents=(0.5, 0.5, 0.5), position=(0, 0, 0), rgb=(0, 1, 0), alpha: float = 1.0):
        from grasptrajopt_tpu_torch.models.mesh import box_mesh

        mesh = box_mesh([2 * h for h in half_extents])
        self.mesh(mesh.vertices + np.asarray(position), mesh.faces, rgb=rgb, alpha=alpha)

    def cylinder(self, radius: float = 1.0, height: float = 1.0, position=(0, 0, 0), rgb=(0, 1, 0), alpha: float = 1.0):
        from grasptrajopt_tpu_torch.models.mesh import cylinder_mesh

        mesh = cylinder_mesh(radius, height)
        self.mesh(mesh.vertices + np.asarray(position), mesh.faces, rgb=rgb, alpha=alpha)

    def text(self, position, msg: str, scale=None, rgb=(0, 0, 0)):
        self.ax.text(position[0], position[1], position[2], msg, color=tuple(rgb))

    def grid_floor(self, num_cells: int = 10, rgb=(0.5, 0.5, 0.5), extent: float = 2.0):
        xs = np.linspace(-extent, extent, num_cells + 1)
        for x in xs:
            self.line([x, -extent, 0], [x, extent, 0], rgb=rgb, width=0.5)
            self.line([-extent, x, 0], [extent, x, 0], rgb=rgb, width=0.5)

    def mesh(self, vertices, faces, rgb=(0.6, 0.6, 0.6), alpha: float = 1.0, max_faces: int = 600):
        from mpl_toolkits.mplot3d.art3d import Poly3DCollection

        vertices = np.asarray(vertices)
        faces = np.asarray(faces)
        if faces.shape[0] > max_faces:
            idx = np.linspace(0, faces.shape[0] - 1, max_faces).astype(int)
            faces = faces[idx]
        polys = vertices[faces]
        coll = Poly3DCollection(polys, alpha=alpha, facecolor=tuple(rgb), edgecolor="none")
        self.ax.add_collection3d(coll)
        self._track(vertices)

    def obj(self, path: str, rgb=(0.6, 0.6, 0.6), alpha: float = 1.0, transform=None):
        from grasptrajopt_tpu_torch.models.mesh import load_mesh

        mesh = load_mesh(path)
        v = mesh.vertices
        if transform is not None:
            T = np.asarray(transform)
            v = v @ T[:3, :3].T + T[:3, 3]
        self.mesh(v, mesh.faces, rgb=rgb, alpha=alpha)

    stl = obj  # same loader dispatches on extension

    # -- robots ---------------------------------------------------------------

    def robot(
        self,
        robot_model,
        q=None,
        base_position=(0, 0, 0),
        base_orientation=(0, 0, 0),
        euler_degrees: bool = False,
        alpha: float = 1.0,
        rgb=(0.4, 0.4, 0.7),
        model_dir: Optional[str] = None,
    ):
        """Render a RobotModel's visual geometry at configuration q.

        base_orientation: xyzw quaternion (len 4) or RPY Euler (len 3),
        matching the reference's robot() conventions."""
        from grasptrajopt_tpu_torch.models.kinematics import _host_rt2tr
        from grasptrajopt_tpu_torch.models.mesh import geometry_mesh
        from grasptrajopt_tpu_torch.spatial import quat2r, rpy2r, rt2tr

        if q is None:
            q = np.zeros(robot_model.ndof)
        q = np.asarray(q, dtype=float)
        base_orientation = np.asarray(base_orientation, dtype=float)
        if base_orientation.shape[0] == 4:
            R = quat2r(torch.as_tensor(base_orientation))
        else:
            ang = np.radians(base_orientation) if euler_degrees else base_orientation
            R = rpy2r(torch.as_tensor(ang))
        T_base = rt2tr(R, torch.as_tensor(np.asarray(base_position), dtype=R.dtype)).numpy()

        q_t = torch.as_tensor(q, dtype=robot_model.dtype, device=robot_model.device)
        frames = robot_model.fk_all(q_t).double().cpu().numpy()
        model_dir = model_dir or getattr(robot_model, "model_dir", "")
        drew_any = False

        for link in robot_model.urdf.links:
            visual = link.visual
            if visual is None:
                continue
            mesh = geometry_mesh(visual.geometry, model_dir)
            if mesh is None:
                continue
            fidx = robot_model.frame_of(link.name)
            V = _host_rt2tr(visual.rpy, visual.xyz)
            T = T_base @ frames[fidx] @ V
            self.mesh(mesh.vertices @ T[:3, :3].T + T[:3, 3], mesh.faces, rgb=rgb, alpha=alpha)
            drew_any = True
        if not drew_any:
            # skeleton fallback: lines between link origins along the tree
            kin = robot_model.kinematics
            for f in range(1, len(kin.frame_names)):
                p0 = (T_base @ frames[kin.parent[f]])[:3, 3]
                p1 = (T_base @ frames[f])[:3, 3]
                self.line(p0, p1, rgb=rgb, width=2.0, alpha=alpha)

    def robot_traj(self, robot_model, Q, alpha_spec=None, **kwargs):
        """Ghost trajectory: render the robot at each column of Q (ndof, n)
        with an alpha ramp (parity: visualize.py:1171 styles A/B/C)."""
        Q = np.asarray(Q)
        n = Q.shape[1]
        style = (alpha_spec or {}).get("style", "A")
        if style == "A":
            alphas = np.linspace(0.1, 1.0, n)
        elif style == "B":
            alphas = np.linspace(1.0, 0.1, n)
        else:
            alphas = np.full(n, (alpha_spec or {}).get("alpha", 0.5))
        for i in range(n):
            self.robot(robot_model, Q[:, i], alpha=float(alphas[i]), **kwargs)

    def animate(
        self,
        robot_model,
        Q,
        file_name: Optional[str] = None,
        fps: int = 10,
        callback=None,
        **kwargs,
    ):
        """Animate a joint trajectory Q (ndof, n): the robot re-renders at
        each column on top of the static scene drawn so far (parity: the
        VTK viewer's timer AnimationCallback, optas/visualize.py:44-77,
        which re-poses robot actors per tick).

        `callback(vis, i, q)` runs per frame for extra per-step drawing.
        With `file_name` the frames are written as an animated .gif
        (Pillow writer; always available with matplotlib) — the headless
        stand-in for the interactive loop. Returns the RGB frames."""
        Q = np.asarray(Q)
        self._finalize_axes()
        frames = []
        for i in range(Q.shape[1]):
            n_coll = len(self.ax.collections)
            n_lines = len(self.ax.lines)
            bounds_len = len(self._bounds)
            self.robot(robot_model, Q[:, i], **kwargs)
            if callback is not None:
                callback(self, i, Q[:, i])
            self.fig.canvas.draw()
            buf = np.asarray(self.fig.canvas.buffer_rgba())[..., :3]
            frames.append(buf.copy())
            # drop this frame's dynamic artists, keep the static scene
            for artist in list(self.ax.collections[n_coll:]) + list(self.ax.lines[n_lines:]):
                artist.remove()
            del self._bounds[bounds_len:]
        if file_name is not None:
            from PIL import Image

            imgs = [Image.fromarray(f) for f in frames]
            imgs[0].save(
                file_name,
                save_all=True,
                append_images=imgs[1:],
                duration=int(1000 / fps),
                loop=0,
            )
        return frames

    # -- output ---------------------------------------------------------------

    def _finalize_axes(self):
        if self._bounds:
            all_pts = np.concatenate(self._bounds)
            lo = all_pts.min(axis=0)
            hi = all_pts.max(axis=0)
            center = (lo + hi) / 2
            radius = max((hi - lo).max() / 2, 1e-3)
            self.ax.set_xlim(center[0] - radius, center[0] + radius)
            self.ax.set_ylim(center[1] - radius, center[1] + radius)
            self.ax.set_zlim(center[2] - radius, center[2] + radius)
        self.ax.set_xlabel("x")
        self.ax.set_ylabel("y")
        self.ax.set_zlabel("z")

    def save(self, file_name: str) -> None:
        self._finalize_axes()
        self.fig.savefig(file_name, dpi=100, bbox_inches="tight")

    def animate_interactive(self, robot_model, Q, fps: int = 10, **kwargs):
        """Interactive animated-robot viewer (parity with the reference's
        VTK timer loop, optas/visualize.py:44-77 + :1303 start): the robot
        re-poses per tick on top of the static scene, with keyboard
        transport — space pauses/resumes, left/right single-step while
        paused, up/down halve/double the frame interval, q closes.

        Headless backends (Agg) have no event loop to run; there the call
        degrades to a no-op after building frame 0 so scripted callers can
        invoke it unconditionally. Returns the matplotlib animation object
        (kept alive by the caller's scope while the window runs)."""
        import matplotlib.animation as _anim

        Q = np.asarray(Q)
        self._finalize_axes()
        state = {"i": 0, "paused": False, "interval": 1000.0 / fps}
        n_coll = len(self.ax.collections)
        n_lines = len(self.ax.lines)
        bounds_len = len(self._bounds)

        def draw_frame(i):
            for artist in list(self.ax.collections[n_coll:]) + list(self.ax.lines[n_lines:]):
                artist.remove()
            del self._bounds[bounds_len:]
            self.robot(robot_model, Q[:, i % Q.shape[1]], **kwargs)
            self.ax.set_title(
                f"step {i % Q.shape[1] + 1}/{Q.shape[1]}"
                + ("  [paused]" if state["paused"] else "")
            )

        def tick(_frame):
            if not state["paused"]:
                state["i"] += 1
                draw_frame(state["i"])
            return []

        def on_key(event):
            if event.key == " ":
                state["paused"] = not state["paused"]
                draw_frame(state["i"])
                self.fig.canvas.draw_idle()
            elif event.key in ("left", "right") and state["paused"]:
                state["i"] += 1 if event.key == "right" else -1
                draw_frame(state["i"])
                self.fig.canvas.draw_idle()
            elif event.key in ("up", "down"):
                state["interval"] *= 0.5 if event.key == "up" else 2.0
                ani.event_source.interval = max(10.0, state["interval"])
            elif event.key == "q":
                self.close()

        draw_frame(0)
        ani = _anim.FuncAnimation(
            self.fig, tick, interval=state["interval"],
            cache_frame_data=False,
        )
        self.fig.canvas.mpl_connect("key_press_event", on_key)
        # exposed for tests / programmatic transport
        self._transport_key_handler = on_key
        backend = self._plt.get_backend().lower()
        if "agg" not in backend:  # a real window: run the event loop
            self._plt.show()
        return ani

    def start(self) -> None:
        self._finalize_axes()
        self._plt.show()

    def close(self) -> None:
        self._plt.close(self.fig)
