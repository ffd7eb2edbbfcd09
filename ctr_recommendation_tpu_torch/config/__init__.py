from ctr_recommendation_tpu_torch.config.loader import (
    load_experiment,
    microlens_experiment,
    microlens_features,
)
from ctr_recommendation_tpu_torch.config.schema import (
    DatasetConfig,
    ExperimentConfig,
    FeatureSpec,
    FeatureType,
    MeshConfig,
    ModelConfig,
    TrainConfig,
)
from ctr_recommendation_tpu_torch.config import serialize  # noqa: E402

__all__ = [
    "DatasetConfig",
    "ExperimentConfig",
    "FeatureSpec",
    "FeatureType",
    "MeshConfig",
    "ModelConfig",
    "TrainConfig",
    "load_experiment",
    "microlens_experiment",
    "microlens_features",
    "serialize",
]
