from ctr_recommendation_tpu_torch.features.feature_map import (
    FeatureMap,
    TableSpec,
    build_feature_map,
)

__all__ = ["FeatureMap", "TableSpec", "build_feature_map"]
