"""Voxel grids, depth-camera cost fields, mesh surface clouds, scene point
sets and the differentiable SDF program (port of grasptrajopt_tpu/fields)."""

from grasptrajopt_tpu_torch.fields.voxel_grid import VoxelGrid, OccupancyGrid2D
from grasptrajopt_tpu_torch.fields.depth_point_cloud import (
    DepthPointCloud,
    FusedDepthPointCloud,
)
from grasptrajopt_tpu_torch.fields.surface_point_cloud import (
    SurfacePointCloud,
    get_surface_point_cloud,
    mesh_to_sdf,
    mesh_to_voxels,
    sample_sdf_near_surface,
)
from grasptrajopt_tpu_torch.fields.scene_points import (
    ScenePointSet,
    downsample_scene,
    scene_point_sets_from_depth,
)
from grasptrajopt_tpu_torch.fields.sdf_program import make_sdf_program, sdf_value_jac_hess

__all__ = [
    "ScenePointSet",
    "downsample_scene",
    "scene_point_sets_from_depth",
    "make_sdf_program",
    "sdf_value_jac_hess",
    "VoxelGrid",
    "OccupancyGrid2D",
    "DepthPointCloud",
    "FusedDepthPointCloud",
    "SurfacePointCloud",
    "get_surface_point_cloud",
    "mesh_to_sdf",
    "mesh_to_voxels",
    "sample_sdf_near_surface",
]
