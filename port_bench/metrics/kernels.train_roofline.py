"""kernels.train_roofline: the least time of every hand-written call in the
window's training steps (the yardstick's bound of each, calls from the
wrappers' launch counters) over the device time of every ``ctr::`` kernel,
in %."""

from harness import calls

UNIT = "%"
LAYER = "hand-written kernels (ops/cuda, csrc)"
MOVES = "train_examples_per_s"


def read(run):
    if run.kind != "train":
        return None
    return calls.roofline_pct(run, calls.hand_written_ms(run), calls.HAND_WRITTEN)
