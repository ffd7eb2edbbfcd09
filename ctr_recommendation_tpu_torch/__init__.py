"""PyTorch + CUDA port of ctr_recommendation_tpu for NVIDIA Hopper.

Mirrors the JAX package's layout module for module. The serving path
(config -> features -> data -> models -> inference -> cli) runs in PyTorch;
the two fused kernels on it (ops/cuda/) are hand-written CUDA C++ built from
csrc/ with nvcc at first use. Nothing here imports jax or the JAX package.
"""

__version__ = "0.1.0"
