"""The reference's frozen copies of the port's draws and schedule agree
with the port's own, bit for bit; the control's fp8 rounding rounds."""

import pytest
import torch

from reference import philox, precision
from reference import train as ref_train


@pytest.mark.parametrize("seed,e,layer,branch,rate,token0", [
    (7, 50, 0, 0, 0.2, 0), (2**62 + 12345, 50, 1, 1, 0.2, 0), (3, 128, 0, 1, 0.1, 2**32 - 5),
])
def test_encoder_keep_is_the_ports_mask(seed, e, layer, branch, rate, token0):
    from ctr_recommendation_tpu_torch.ops.cuda.encoder_blocks import dropout_mask

    s = torch.tensor([seed], dtype=torch.int64)
    got = philox.encoder_keep(s, 1000, e, layer, branch, rate, token0)
    assert torch.equal(got, dropout_mask(s, 1000, e, layer, branch, rate, token0))


@pytest.mark.parametrize("seed,step", [(0, 0), (2025, 3), (2**31 - 1, 2**40)])
def test_step_seed_is_the_trainers(seed, step):
    from ctr_recommendation_tpu_torch.training.loop import _seed

    assert philox.step_seed(seed, step) == _seed(seed + 1, step)


def test_onecycle_is_the_ports_schedule():
    from ctr_recommendation_tpu_torch.config.schema import TrainConfig
    from ctr_recommendation_tpu_torch.training.optim import make_schedule

    cfg = TrainConfig()
    train = {k: getattr(cfg, k) for k in ("learning_rate", "onecycle_peak_factor",
                                          "onecycle_pct_start", "onecycle_div_factor",
                                          "onecycle_final_div_factor")}
    sched = make_schedule(cfg, 20000)
    for count in (0, 1, 2, 5999, 6000, 6001, 19999, 20000, 30000):
        assert ref_train.onecycle_lr(count, train, 20000) == sched(count)


def test_fp8_control_rounds_values_and_gradients():
    x = torch.linspace(-3, 3, 1001, requires_grad=True)
    y = precision.fp8(x)
    rel = ((y - x).abs() / x.abs().clamp(min=1e-3)).max()
    assert 1e-3 < float(rel) < 0.1  # 3 mantissa bits
    y.backward(torch.full_like(x, 0.3))
    assert len(torch.unique(x.grad)) == 1 and float(x.grad[0]) != 0.0
