from ctr_recommendation_tpu_torch.utils.profiling import trace
from ctr_recommendation_tpu_torch.utils.seeding import set_seed

__all__ = ["set_seed", "trace"]
