from ctr_recommendation_tpu_torch.training.checkpoint import CheckpointManager
from ctr_recommendation_tpu_torch.training.loop import Trainer, bce_with_logits
from ctr_recommendation_tpu_torch.training.optim import make_optimizer, make_schedule
from ctr_recommendation_tpu_torch.training.train_state import TrainState

__all__ = [
    "CheckpointManager",
    "Trainer",
    "TrainState",
    "bce_with_logits",
    "make_optimizer",
    "make_schedule",
]
