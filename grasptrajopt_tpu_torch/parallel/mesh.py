"""Process groups, the data mesh and batch sharding on torch.distributed.

Port of grasptrajopt_tpu/parallel/mesh.py. One process drives one device
(a rank), so the data mesh is the ranks of the default process group, one
device each, and sharding a batch means each rank keeps its own slice of
its leading axis: every rank holds the same host batch (as every JAX
process does before `device_put`), so no collective is needed to shard
it. The slices are plain tensors, because the port's solvers are eager
batch-first functions of plain tensors.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.utils._pytree import tree_map

# the launcher's environment that names a cluster (torchrun sets all of them)
CLUSTER_ENV = ("MASTER_ADDR", "RANK", "WORLD_SIZE")


def _init_method(coordinator: Optional[str]) -> str:
    """A torch init method from a coordinator: a URL (tcp://, file://,
    env://) as given, a bare host:port (JAX's form) as tcp://, none as
    env:// (the launcher's MASTER_ADDR / MASTER_PORT)."""
    if coordinator is None:
        return "env://"
    return coordinator if "://" in coordinator else f"tcp://{coordinator}"


def distributed_init(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, device="cuda") -> bool:
    """Initialize the default process group (a no-op on a plain host).

    The backend is NCCL where `device` is a CUDA device (it raises where
    CUDA or NCCL is missing: there is no CPU fallback) and gloo where the
    caller asks for the CPU. With explicit (coordinator, num_processes,
    process_id) it initializes when num_processes > 1 and is a no-op for
    one process, as the JAX version. Without num_processes it initializes
    when a coordinator is given or the launcher's environment names a
    cluster (`CLUSTER_ENV`, as torchrun sets it), taking the world size
    and rank from WORLD_SIZE / RANK (default 1 / 0), and is a no-op
    otherwise. A CUDA rank drives device LOCAL_RANK (default: its rank
    modulo the devices). Returns whether this call initialized the group.
    """
    if num_processes is not None:
        if num_processes <= 1:
            return False
        world, rank = num_processes, process_id
    elif coordinator is not None or any(os.environ.get(k) for k in CLUSTER_ENV):
        world = int(os.environ.get("WORLD_SIZE", "1"))
        rank = int(os.environ.get("RANK", "0"))
    else:
        return False
    if rank is None:
        raise ValueError("distributed_init: process_id is required with num_processes")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available() or not dist.is_nccl_available():
            raise RuntimeError("distributed_init: a CUDA device needs CUDA and NCCL; pass device='cpu' for gloo")
        index = dev.index if dev.index is not None else int(
            os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(index)
        dist.init_process_group("nccl", init_method=_init_method(coordinator), world_size=world, rank=rank,
                                device_id=torch.device("cuda", index))
    elif dev.type == "cpu":
        dist.init_process_group("gloo", init_method=_init_method(coordinator), world_size=world, rank=rank)
    else:
        raise ValueError(f"distributed_init: no backend for device {dev}")
    return True


def data_mesh(n_devices: Optional[int] = None, axis_name: str = "dp") -> DeviceMesh:
    """A 1-D data mesh over the ranks of the default process group, one
    device each (CUDA under NCCL, the CPU under gloo). `n_devices`, when
    given, must be the world size: a rank drives one device."""
    if not dist.is_initialized():
        raise RuntimeError("data_mesh: no process group (call distributed_init first)")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"data_mesh: {n_devices} devices asked, the process group has {world} ranks of one each")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (world,), mesh_dim_names=(axis_name,))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank drives on `mesh`."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def shard_batch(tree, mesh: DeviceMesh, axis_name: str = "dp"):
    """This rank's slice of the leading axis of every tensor of a pytree,
    on the rank's device: rank r of n keeps rows [r * B / n, (r + 1) * B / n).
    Raises where a leading axis does not divide over the mesh, as JAX's
    sharding does."""
    n, r = mesh.size(mesh.mesh_dim_names.index(axis_name)), mesh.get_local_rank(axis_name)
    dev = mesh_device(mesh)

    def take(x):
        B = x.shape[0]
        if B % n:
            raise ValueError(f"shard_batch: a leading axis of {B} does not divide over {n} devices")
        b = B // n
        return x[r * b:(r + 1) * b].to(dev)

    return tree_map(take, tree)


def replicate(tree, mesh: DeviceMesh):
    """Every tensor of a pytree whole on this rank's device (every rank
    holds all of it)."""
    dev = mesh_device(mesh)
    return tree_map(lambda x: x.to(dev), tree)
