"""Surface-point sampling and SDF queries on a mesh (headless PNG), on the
port.

Port of examples/mesh_sdf_demo.py (the reference's test_mesh_to_sdf.py
viewer): samples a mesh's surface, queries signed distances around it
(host numpy, fields/surface_point_cloud.py) and writes a colored scatter
(blue inside, red outside) through the port's viz/. The default mesh is
the Panda hand of a robot data tree; `-m` takes any OBJ / STL / DAE.

    python -m grasptrajopt_tpu_torch.mesh_sdf_demo -m part.obj -o mesh_sdf.png
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from grasptrajopt_tpu_torch.fields import get_surface_point_cloud
from grasptrajopt_tpu_torch.models.mesh import load_mesh
from grasptrajopt_tpu_torch.planning.utils import get_data_dir
from grasptrajopt_tpu_torch.viz import Visualizer


def make_args(argv=None):
    parser = argparse.ArgumentParser(description="Mesh surface sampling and SDF queries")
    parser.add_argument(
        "-m", "--mesh",
        default=os.path.join(get_data_dir(), "robots", "panda", "meshes", "visual", "hand.obj"),
    )
    parser.add_argument("-o", "--out", default="mesh_sdf.png")
    return parser.parse_args(argv)


def main(argv=None):
    """Returns (queries (M, 3), sdf (M,))."""
    args = make_args(argv)
    mesh = load_mesh(args.mesh)
    cloud = get_surface_point_cloud(mesh, "sample", sample_point_count=5000)

    rng = np.random.default_rng(0)
    base = cloud.get_random_surface_points(2000, seed=1)
    queries = np.concatenate(
        [base + rng.normal(scale=0.01, size=base.shape),
         base + rng.normal(scale=0.002, size=base.shape)]
    )
    sdf = cloud.get_sdf(queries)

    vis = Visualizer(camera_position=[0.3, 0.3, 0.3])
    vis.points(queries[sdf < 0], rgb=[0, 0, 1], size=2)
    vis.points(queries[sdf > 0], rgb=[1, 0, 0], size=2)
    vis.save(args.out)
    print(
        f"wrote {args.out}: {len(queries)} queries, "
        f"{(sdf < 0).mean() * 100:.0f}% inside, sdf range "
        f"[{sdf.min():.4f}, {sdf.max():.4f}]"
    )
    return queries, sdf


if __name__ == "__main__":
    main()
