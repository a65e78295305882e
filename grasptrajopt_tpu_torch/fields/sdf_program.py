"""Differentiable SDF field program: value / Jacobian / Hessian.

Port of grasptrajopt_tpu/fields/sdf_program.py. The trilinear field lookup
(`VoxelGrid.lookup_trilinear`, plain torch) is differentiable, so
`torch.func.grad` / `hessian` give the exact derivatives of the
interpolant: no finite differences. This packages them as an explicit
(f, J, H) function triple over one 3-point, batched with `vmap`.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
from torch.func import grad, hessian, vmap

from grasptrajopt_tpu_torch.fields.voxel_grid import VoxelGrid


def make_sdf_program(grid: VoxelGrid, field_flat) -> Tuple[Callable, Callable, Callable]:
    """Returns (value_fn, jac_fn, hess_fn) over a single point p (3,):

    value_fn(p) -> scalar trilinear field value
    jac_fn(p)   -> (3,) exact gradient of the interpolant
    hess_fn(p)  -> (3, 3) exact Hessian (the mixed terms of the
                   interpolant; its pure second derivatives are zero inside
                   a cell)
    """

    def value_fn(p):
        return grid.lookup_trilinear(field_flat, p[None])[0]

    return value_fn, grad(value_fn), hessian(value_fn)


def sdf_value_jac_hess(grid: VoxelGrid, field_flat, points):
    """Batched (values (N,), jacobians (N, 3), hessians (N, 3, 3)) at
    points (N, 3) in the field's dtype and on its device."""
    value_fn, jac_fn, hess_fn = make_sdf_program(grid, field_flat)
    return vmap(value_fn)(points), vmap(jac_fn)(points), vmap(hess_fn)(points)
