"""kernels.score_roofline: the least time of every hand-written call in the
window's scoring (the fused scoring call a batch, and the encoder's forward
in SASRec models) over the device time of every ``ctr::`` kernel, in %."""

from harness import calls

UNIT = "%"
LAYER = "hand-written kernels (ops/cuda, csrc)"
MOVES = "score_rows_per_s"


def read(run):
    if run.kind != "score":
        return None
    return calls.roofline_pct(run, calls.hand_written_ms(run), calls.HAND_WRITTEN)
