"""attention.train_roofline: the least time of the encoder's attention in
the window's training steps (fp32 work the faster way: 3xTF32 on the tensor
cores or fp32 on the CUDA cores, or its bytes) over the device time of the
``ctr::enc::attention_*`` kernels, in %."""

from harness import calls

UNIT = "%"
LAYER = "encoder attention (ops/cuda/sasrec_encoder.py)"
MOVES = "train_examples_per_s"


def read(run):
    if run.kind != "train":
        return None
    return calls.roofline_pct(run, calls.attention_ms(run), calls.ATTENTION_KERNELS)
