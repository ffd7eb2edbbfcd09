"""device.idle_share.score: the share of the traced window in which no
kernel, copy or set ran on the device, in %."""

UNIT = "%"
LAYER = "device (H100)"
MOVES = "score_rows_per_s"


def read(run):
    if run.kind != "score" or run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
