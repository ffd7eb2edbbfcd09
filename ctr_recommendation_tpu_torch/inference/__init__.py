from ctr_recommendation_tpu_torch.inference.pipeline import run_submission_pipeline
from ctr_recommendation_tpu_torch.inference.predictor import Predictor
from ctr_recommendation_tpu_torch.inference.submission import write_submission

__all__ = ["Predictor", "run_submission_pipeline", "write_submission"]
