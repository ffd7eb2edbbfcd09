"""table_grad_roofline: the least time of the window's table-gradient calls
(bytes at 3.35 TB/s; shapes from the yardstick's ``tg_step_shapes``, calls
from ``table_grad``'s launch counter) over the device time of its kernels,
in %."""

from harness import calls

UNIT = "%"
LAYER = "table gradient (ops/cuda/table_grad.py)"
MOVES = "train_examples_per_s"


def read(run):
    if run.kind != "train":
        return None
    return calls.roofline_pct(run, calls.table_grad_ms(run), calls.TABLE_GRAD_KERNELS)
