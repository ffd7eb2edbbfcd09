from ctr_recommendation_tpu_torch.utils.profiling import StepTimer, trace
from ctr_recommendation_tpu_torch.utils.seeding import set_seed

__all__ = ["StepTimer", "set_seed", "trace"]
