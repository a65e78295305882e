"""Voxel grids, depth-camera cost fields and mesh surface clouds."""
