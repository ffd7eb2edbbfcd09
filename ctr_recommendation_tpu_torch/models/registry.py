"""Model registry: the config's ``model:`` key -> model module, the JAX
package's eleven names.

Every registered model implements
    init(gen, feature_map, model_cfg) -> (params, state)
    apply(params, state, feature_map, model_cfg, batch, *, train, generator,
          compute_dtype, weight, lookup) -> (logits (B,), new_state)
and names its history pooling in ``SEQ_POOLING``.
"""

from __future__ import annotations

import types

import torch

from ctr_recommendation_tpu_torch.config.schema import ModelConfig
from ctr_recommendation_tpu_torch.features.feature_map import FeatureMap
from ctr_recommendation_tpu_torch.models import (
    autoint,
    dcnv2,
    deepfm,
    din,
    dlrm,
    fibinet,
    finalmlp,
    masknet,
    pnn,
    sasrec_fibinet,
    xdeepfm,
)

_REGISTRY: dict[str, types.ModuleType] = {}


def register(name: str, module: types.ModuleType) -> None:
    _REGISTRY[name.lower()] = module


def get_model(name: str) -> types.ModuleType:
    key = name.lower()
    if key not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; registered: {sorted(_REGISTRY)}")
    return _REGISTRY[key]


def available_models() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


register("fibinet", fibinet)
register("mm_fibinet", fibinet)
register("xdeepfm", xdeepfm)
register("finalmlp", finalmlp)
register("sasrec_fibinet", sasrec_fibinet)
register("dcnv2", dcnv2)
register("deepfm", deepfm)
register("autoint", autoint)
register("din", din)
register("masknet", masknet)
register("pnn", pnn)
register("dlrm", dlrm)


def build_model(
    feature_map: FeatureMap, model_cfg: ModelConfig, gen: torch.Generator
) -> tuple[types.ModuleType, dict, dict]:
    """(module, params, state), parameters drawn on the CPU from ``gen``."""
    module = get_model(model_cfg.model)
    params, state = module.init(gen, feature_map, model_cfg)
    return module, params, state
