"""mfu.train: the model's operations in the window's training steps (three
times the eval forward's an example, at the published widths, whatever
implements them) over the traced window at the bf16 peak, in %."""

from harness.yardstick import PEAK_FLOPS, model_flops_per_example

UNIT = "%"
LAYER = "Trainer (training/loop.py)"
MOVES = "train_examples_per_s"


def read(run):
    if run.kind != "train" or run.trace is None:
        return None
    flops = 3 * model_flops_per_example(run.sizes) * run.batch * run.stats["steps"]
    return 100.0 * flops / (run.trace.window_s * PEAK_FLOPS["bfloat16"])
