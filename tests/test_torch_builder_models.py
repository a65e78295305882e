"""The models the builder allocates from, against the JAX package's:
Model / TaskModel state names and limits, RobotModel's URDF / xacro
constructor keywords (the joint bookkeeping, qddlim, T), a xacro string
expanded identically and a xacro file loaded by the constructor, the
kinematic-tree constructor the GTO robot uses, and the planar IK entry
point (`python -m grasptrajopt_tpu_torch.planar_ik --device cpu`)."""

import os
import subprocess
import sys

import numpy as np
import torch

import jax.numpy as jnp

from grasptrajopt_tpu.models import RobotModel as JaxRobot
from grasptrajopt_tpu.models import TaskModel as JaxTask
from grasptrajopt_tpu.models.xacro import process_xacro_string as jax_xacro
from grasptrajopt_tpu_torch.models import RobotModel, TaskModel
from grasptrajopt_tpu_torch.models.xacro import process_xacro_string
from grasptrajopt_tpu_torch.planning.gto_models import GTORobotModel
from grasptrajopt_tpu_torch.testing import SYNTH_ARM_URDF, SYNTH_PARAM_JOINTS, make_synthetic_gto_robot
from test_xacro import SIMPLE
from torch_parity import np_, t64

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_task_model_names_and_limits():
    lim = {0: (np.array([-1.0, -2.0]), np.array([1.0, 2.0]))}
    jt = JaxTask("base", dim=2, time_derivs=[0, 1], dlim=lim)
    tt = TaskModel("base", dim=2, time_derivs=[0, 1], dlim=lim)
    for d in (0, 1):
        assert tt.state_name(d) == jt.state_name(d)
        assert tt.state_optimized_name(d) == jt.state_optimized_name(d)
        assert tt.state_parameter_name(d) == jt.state_parameter_name(d)
    assert tt.state_optimized_name(1) == "base/dy/x"
    for x in ([0.5, 1.5], [1.5, 0.0]):
        assert bool(tt.in_limit(t64(x), 0)) == bool(jt.in_limit(jnp.asarray(x), 0))
    assert TaskModel("t", 1).dlim == {} and not TaskModel("t", 1).is_discrete


def test_robot_model_keywords_match():
    kw = dict(time_derivs=[0, 1, 2], qddlim=3.5, T=20, param_joints=SYNTH_PARAM_JOINTS, name="arm")
    jr = JaxRobot(urdf_string=SYNTH_ARM_URDF, dtype=jnp.float64, **kw)
    tr = RobotModel(urdf_string=SYNTH_ARM_URDF, dtype=torch.float64, device="cpu", **kw)
    assert tr.get_name() == jr.get_name() == "arm" and tr.T == jr.T == 20
    assert tr.time_derivs == jr.time_derivs and tr.dim == jr.dim == 9
    for attr in ("joint_names", "link_names", "actuated_joint_names", "optimized_joint_names",
                 "parameter_joint_names", "optimized_joint_indexes", "parameter_joint_indexes",
                 "num_opt_joints", "num_param_joints", "ndof"):
        assert getattr(tr, attr) == getattr(jr, attr), attr
    assert tr.get_actuated_joint_index("j4") == jr.get_actuated_joint_index("j4") == 3
    for d in (0, 1, 2):
        for a, b in zip(tr.get_limits(d), jr.get_limits(d)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert tr.state_name(2) == "arm/ddq" and tr.get_urdf() is tr.urdf
    q = np.linspace(-0.5, 0.5, 9)
    np.testing.assert_allclose(np_(tr.fk_all(t64(q))), np.asarray(jr.fk_all(jnp.asarray(q))), atol=1e-12)


def test_gto_robot_keeps_its_constructor_and_takes_time_derivs():
    r = make_synthetic_gto_robot(device="cpu", dtype=torch.float64, points_per_link=2)
    assert r.time_derivs == [0, 1] and r.urdf is not None and r.get_name() == "synth7"
    assert r.num_param_joints == 2 and r.num_opt_joints == 7
    one = make_synthetic_gto_robot(device="cpu", dtype=torch.float64, points_per_link=2, time_derivs=(0,))
    assert one.time_derivs == [0]
    # the kinematic-tree constructor (convert.robot_from_numpy's: no URDF)
    bare = GTORobotModel(r.kinematics, r.param_joints, r.lower_actuated_joint_limits, r.upper_actuated_joint_limits,
                         r.velocity_actuated_joint_limits, r.surface_points, r.surface_normals, r.visual_offsets,
                         device="cpu", dtype=torch.float64)
    assert bare.urdf is None and bare.link_names == list(r.kinematics.frame_names) and bare.time_derivs == [0]
    q = t64(np.linspace(0.0, 0.3, 9))
    assert torch.equal(bare.fk_all(q), r.fk_all(q))


def test_xacro_string_expands_identically():
    assert process_xacro_string(SIMPLE) == jax_xacro(SIMPLE)


def test_robot_model_loads_a_xacro_file(tmp_path):
    path = tmp_path / "seg.urdf.xacro"
    # one root: drop the free-standing link
    path.write_text(SIMPLE.replace('<xacro:unless value="false"><link name="always"/></xacro:unless>', ""))
    jr = JaxRobot(xacro_filename=str(path), dtype=jnp.float64)
    tr = RobotModel(urdf_filename=str(path), dtype=torch.float64, device="cpu")
    assert tr.urdf_filename == str(path) and tr.ndof == jr.ndof == 2
    q = np.array([0.3, -0.7])
    np.testing.assert_allclose(np_(tr.get_global_link_transform("lbr_link_2", t64(q))),
                               np.asarray(jr.get_global_link_transform("lbr_link_2", jnp.asarray(q))), atol=1e-12)


def test_planar_ik_entry_point_on_the_cpu():
    from grasptrajopt_tpu_torch import planar_ik

    out = planar_ik.solve("cpu")
    np.testing.assert_allclose(out["reached"], planar_ik.TARGET, atol=planar_ik.REACH_TOL)
    np.testing.assert_allclose(out["reached_slsqp"], planar_ik.TARGET, atol=planar_ik.REACH_TOL)
    np.testing.assert_allclose(out["lm"][0], out["slsqp"][0], atol=1e-4)
    run = subprocess.run([sys.executable, "-m", "grasptrajopt_tpu_torch.planar_ik", "--device", "cpu"],
                         cwd=REPO, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    assert "LM solution" in run.stdout and "SLSQP solution" in run.stdout


def test_builder_entry_points_default_to_the_card():
    """The builder stack's entry points place their tensors on the card
    unless asked for the CPU; without a card, a solver asked for it
    raises instead of moving to the CPU."""
    import inspect

    import pytest

    from grasptrajopt_tpu_torch import planar_ik
    from grasptrajopt_tpu_torch.opt import BlockLayout, OptimizationBuilder, Solver
    from grasptrajopt_tpu_torch.opt.scipy_oracle import solve_scipy_box
    from grasptrajopt_tpu_torch.testing import make_synthetic_gto_robot as synth

    for fn in (RobotModel.__init__, OptimizationBuilder.__init__, planar_ik.solve,
               solve_scipy_box, synth, BlockLayout.vec, BlockLayout.zeros_dict):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__qualname__
    b = OptimizationBuilder(T=1)
    b.add_decision_variables("x", 2)
    b.add_cost_term("c", lambda x, p: torch.sum(x["x"] ** 2))
    opt = b.build()
    assert opt.device.type == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the solver runs there")
    with pytest.raises((AssertionError, RuntimeError)):
        Solver(opt)
