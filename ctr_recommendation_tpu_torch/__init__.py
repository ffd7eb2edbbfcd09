"""PyTorch + CUDA port of ctr_recommendation_tpu for NVIDIA Hopper.

Mirrors the JAX package's layout module for module. The serving path
(config -> features -> data -> models -> inference -> cli) and the
single-device training path (training/, cli/train.py) run in PyTorch; the
fused kernels on them (ops/cuda/: the interaction forward and backward, the
scoring kernel) are hand-written CUDA C++ built from csrc/ with nvcc at
first use. Nothing here imports jax or the JAX package.
"""

__version__ = "0.1.0"
