"""Seeding: the host-side ``random`` and ``numpy`` generators the input
pipeline uses, seeded as the JAX package seeds them, and a root torch
generator in place of its root ``jax.random.key``. torch's global generator
is left alone: the port draws from explicit generators everywhere else."""

from __future__ import annotations

import random

import numpy as np
import torch

from ctr_recommendation_tpu_torch.utils.device import resolve_device


def set_seed(seed: int = 2025, device: str | torch.device = "cuda") -> torch.Generator:
    random.seed(seed)
    np.random.seed(seed)
    return torch.Generator(device=resolve_device(device)).manual_seed(seed)
