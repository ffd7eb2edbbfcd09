"""attention.score_roofline: the least time of the encoder's attention
forward in the window's scoring over the device time of the
``ctr::enc::attention_*`` kernels, in %."""

from harness import calls

UNIT = "%"
LAYER = "encoder attention (ops/cuda/sasrec_encoder.py)"
MOVES = "score_rows_per_s"


def read(run):
    if run.kind != "score":
        return None
    return calls.roofline_pct(run, calls.attention_ms(run), calls.ATTENTION_KERNELS)
