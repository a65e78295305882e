"""Robot models: URDF parsing, meshes, kinematics (port of grasptrajopt_tpu.models)."""
