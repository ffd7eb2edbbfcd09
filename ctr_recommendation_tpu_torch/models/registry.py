"""Model registry: the config's ``model:`` key -> model module.

Every registered model implements
    init(gen, feature_map, model_cfg) -> (params, state)
    apply(params, state, feature_map, model_cfg, batch, *, train, generator,
          compute_dtype, weight, lookup) -> (logits (B,), new_state)
Ported so far: the FiBiNET family and sasrec_fibinet, train and eval.
"""

from __future__ import annotations

import types

import torch

from ctr_recommendation_tpu_torch.config.schema import ModelConfig
from ctr_recommendation_tpu_torch.features.feature_map import FeatureMap
from ctr_recommendation_tpu_torch.models import fibinet, sasrec_fibinet

_REGISTRY: dict[str, types.ModuleType] = {
    "fibinet": fibinet, "mm_fibinet": fibinet, "sasrec_fibinet": sasrec_fibinet,
}


def get_model(name: str) -> types.ModuleType:
    key = name.lower()
    if key not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; registered: {sorted(_REGISTRY)}")
    return _REGISTRY[key]


def build_model(
    feature_map: FeatureMap, model_cfg: ModelConfig, gen: torch.Generator
) -> tuple[types.ModuleType, dict, dict]:
    """(module, params, state), parameters drawn on the CPU from ``gen``."""
    module = get_model(model_cfg.model)
    params, state = module.init(gen, feature_map, model_cfg)
    return module, params, state
