"""PyTorch + CUDA port of ctr_recommendation_tpu for NVIDIA Hopper.

Mirrors the JAX package's layout module for module. The serving path
(config -> features -> data -> models -> inference -> cli) and the
single-device training path (training/, cli/train.py) run in PyTorch; the
fused kernels on them (ops/cuda/: the interaction forward and backward, the
scoring kernel) are hand-written CUDA C++ built from csrc/ with nvcc at
first use. Nothing here imports jax or the JAX package.

Importing the package loads only its version: ``Trainer``, ``Predictor``,
``build_model`` and ``microlens_experiment`` resolve on first access, and
no kernel is built and no CUDA context made until a caller asks for one.
"""

from ctr_recommendation_tpu_torch.version import __version__


def __getattr__(name):
    if name == "Trainer":
        from ctr_recommendation_tpu_torch.training import Trainer

        return Trainer
    if name == "Predictor":
        from ctr_recommendation_tpu_torch.inference import Predictor

        return Predictor
    if name == "build_model":
        from ctr_recommendation_tpu_torch.models import build_model

        return build_model
    if name == "microlens_experiment":
        from ctr_recommendation_tpu_torch.config import microlens_experiment

        return microlens_experiment
    raise AttributeError(name)


__all__ = [
    "Predictor",
    "Trainer",
    "__version__",
    "build_model",
    "microlens_experiment",
]
