"""The port's parallel/{mesh,sharded}.py against the JAX package's, on
the CPU: two gloo processes through `distributed_init` (the JAX
two-process test's problem, and the bench's sharded stacked-field solve
against the unsharded one), the same box-LM problem through the JAX
`make_sharded_solver` on a one-device mesh and the port's at a world of
one, and `distributed_init`'s no-op and its refusal of a CUDA device
without CUDA."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax.numpy as jnp

import torch_parity  # noqa: F401  (one intra-op thread)
from grasptrajopt_tpu.opt import make_box_lm_solver as jax_make_box_lm_solver
from grasptrajopt_tpu.opt.lm import LMConfig as JaxLMConfig
from grasptrajopt_tpu.parallel import data_mesh as jax_data_mesh
from grasptrajopt_tpu.parallel import make_sharded_solver as jax_make_sharded_solver
from grasptrajopt_tpu.parallel import shard_batch as jax_shard_batch
from grasptrajopt_tpu_torch import parallel
from grasptrajopt_tpu_torch.opt.lm import LMConfig, make_box_lm_solver
from grasptrajopt_tpu_torch.parallel import mesh as port_mesh

_WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_distributed_worker.py")
WORKER_TIMEOUT_S = 300


@pytest.fixture
def no_cluster_env(monkeypatch):
    for k in port_mesh.CLUSTER_ENV + ("LOCAL_RANK", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)


def test_two_gloo_processes(tmp_path):
    world = 2
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(_WORKER)))
    for k in port_mesh.CLUSTER_ENV:
        env.pop(k, None)
    coordinator = f"file://{tmp_path}/store"
    outs = [tmp_path / f"rank{i}.json" for i in range(world)]
    procs = [
        subprocess.Popen([sys.executable, _WORKER, str(i), str(world), coordinator, str(outs[i])],
                         env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i in range(world)
    ]
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=WORKER_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        logs.append(out.decode(errors="replace"))
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"rank {i} failed:\n{logs[i]}"
    results = [json.loads(path.read_text()) for path in outs]
    for i, r in enumerate(results):
        assert r["initialized"] and r["rank"] == i and r["world"] == world and r["backend"] == "gloo"
        assert abs(r["mean"] - r["mean_expected"]) < 1e-6
        assert r["solve_max_err"] < 1e-4
        assert r["mean_cost"] == pytest.approx(r["mean_cost_of_gathered"], rel=1e-6, abs=1e-12)
        assert r["ragged_refused"]
        # the sharded stacked-field solve is the unsharded one (float64)
        assert r["stacked_shape"] == [2, 12, 7]
        assert r["stacked_q_max_err"] < 1e-12
        assert r["stacked_mean_cost"] == pytest.approx(r["stacked_mean_cost_ref"], rel=1e-12)
    # every rank holds the same global metrics and gates
    for key in ("mean", "mean_cost", "stacked_mean_cost", "stacked_gates"):
        assert results[0][key] == results[1][key]


def test_world_of_one_matches_the_jax_sharded_solver(tmp_path, no_cluster_env):
    """The JAX package's TestSharding problem (16 targets, 15 LM
    iterations, float32) through the JAX sharded solver on a one-device
    mesh and the port's at a world of one (gloo)."""
    targets = np.random.default_rng(0).normal(size=(16, 3)).astype(np.float32)

    inner = jax_make_box_lm_solver(lambda x, p: x - p, config=JaxLMConfig(iterations=15))
    mesh_j = jax_data_mesh(1)
    sharded_j = jax_make_sharded_solver(lambda t: inner(jnp.zeros(3), -5 * jnp.ones(3), 5 * jnp.ones(3), t), mesh_j)
    (xs_j, cs_j, _), metrics_j = sharded_j(jax_shard_batch(jnp.asarray(targets), mesh_j))

    assert parallel.distributed_init(coordinator=f"file://{tmp_path}/store", device="cpu")
    try:
        mesh = parallel.data_mesh(1)
        port_inner = make_box_lm_solver(lambda x, p: x - p, LMConfig(iterations=15))
        sharded = parallel.make_sharded_solver(
            lambda t: port_inner(torch.zeros(t.shape[0], 3), -5 * torch.ones(3), 5 * torch.ones(3), t), mesh
        )
        (xs, cs, _), metrics = sharded(*parallel.shard_batch((torch.as_tensor(targets),), mesh))
        mean = parallel.sharded_metric_reduce(parallel.shard_batch(torch.arange(16.0), mesh), mesh)
    finally:
        dist.destroy_process_group()
    assert xs.dtype == torch.float32 and metrics["mean_cost"].dim() == 0
    np.testing.assert_allclose(xs.numpy(), np.asarray(xs_j), atol=1e-5)
    np.testing.assert_allclose(cs.numpy(), np.asarray(cs_j), atol=1e-5)
    assert float(metrics["mean_cost"]) == pytest.approx(float(metrics_j["mean_cost"]), abs=1e-5)
    assert float(mean) == pytest.approx(7.5, abs=1e-6)


def test_shard_batch_and_replicate_at_a_world_of_one(tmp_path, no_cluster_env):
    assert parallel.distributed_init(coordinator=f"file://{tmp_path}/store", device="cpu")
    try:
        mesh = parallel.data_mesh()
        tree = {"a": torch.arange(6.0).reshape(3, 2), "b": (torch.ones(3, dtype=torch.bool),)}
        local = parallel.shard_batch(tree, mesh)
        whole = port_mesh.replicate(tree, mesh)
        with pytest.raises(ValueError):
            parallel.data_mesh(2)
    finally:
        dist.destroy_process_group()
    assert torch.equal(local["a"], tree["a"]) and torch.equal(local["b"][0], tree["b"][0])
    assert torch.equal(whole["a"], tree["a"])


def test_distributed_init_is_a_no_op_on_a_plain_host(no_cluster_env):
    assert parallel.distributed_init() is False
    assert parallel.distributed_init(num_processes=1, process_id=0, device="cpu") is False
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError):
        parallel.data_mesh()


def test_distributed_init_on_cuda_needs_cuda_and_nccl(tmp_path, no_cluster_env, monkeypatch):
    """A CUDA device gets NCCL or an error, never a quiet gloo group."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        parallel.distributed_init(f"file://{tmp_path}/store", num_processes=2, process_id=0)
    with pytest.raises(RuntimeError):
        parallel.distributed_init(coordinator=f"file://{tmp_path}/store")
    assert not dist.is_initialized()
