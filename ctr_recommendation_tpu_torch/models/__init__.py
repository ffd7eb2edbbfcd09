from ctr_recommendation_tpu_torch.models.registry import available_models, build_model, get_model

__all__ = ["available_models", "build_model", "get_model"]
