"""PyTorch + CUDA port of grasptrajopt_tpu/ for NVIDIA Hopper (H100).

Same subpackage layout as the JAX package, which stays the reference. The
port imports torch and never jax. Hand-written CUDA kernels live in
`csrc/` and build with nvcc at first use (see `ops/cuda_build.py`).
"""
