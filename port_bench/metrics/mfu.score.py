"""mfu.score: the model's eval-forward operations on the rows scored in the
window (at the published widths, whatever implements them) over the traced
window at the bf16 peak, in %."""

from harness.yardstick import PEAK_FLOPS, model_flops_per_example

UNIT = "%"
LAYER = "Predictor (inference/predictor.py)"
MOVES = "score_rows_per_s"


def read(run):
    if run.kind != "score" or run.trace is None:
        return None
    flops = model_flops_per_example(run.sizes) * run.stats["rows"]
    return 100.0 * flops / (run.trace.window_s * PEAK_FLOPS["bfloat16"])
