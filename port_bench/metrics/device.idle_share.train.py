"""device.idle_share.train: the share of the traced window in which no
kernel, copy or set ran on the device, in %."""

UNIT = "%"
LAYER = "device (H100)"
MOVES = "train_examples_per_s"


def read(run):
    if run.kind != "train" or run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
