from ctr_recommendation_tpu_torch.models.registry import build_model, get_model

__all__ = ["build_model", "get_model"]
