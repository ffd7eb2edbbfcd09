"""The gradient of a gather, summed in a fixed order (csrc/table_grad.cu).

``table_grad(ids, cot, rows)`` is ``zeros(rows, E).index_add(0, ids, cot)``:
the table gradient of ``table[ids]``, ids in [0, rows). It replaces no TPU
kernel. It takes the place of PyTorch's dense embedding backward (the
backward of ``F.embedding``), which on an H100 sums a row's cotangents in an
order that changes from call to call (10 calls on the same 8192 ids into
129 rows gave 9 results apart from the first, up to 3.8e-5), so that two
training runs of one seed parted.
Its callers: ``models/trunk.py::TableLookup`` (every gather's backward: the
trunk's, the merged per-table lookup's and the gathered strategy's row
buffers') and ``parallel/embedding.py::_ShardedLookup`` (the row-sharded
lookup's local backward). The JAX package takes the same function as
``jnp.zeros(...).at[ids].add(cot)`` (``training/sparse.py::
multi_feature_lookup``), a fixed-order scatter on a TPU.

On a CUDA tensor the wrapper sorts the ids (``torch.sort``, stable: an
ordering, not the sum) and launches the kernel's two passes
(``launches()``): fixed chunks of sorted positions summed run by run, then
one warp a row adding the partials of the runs that cross chunks, in chunk
order. No atomics: the same inputs give the same bits on every call. Bound
on an H100: bytes (the ids and cotangents read once, the gradient written
once). Envelope (``fits``): any E, ids and rows that fit int32 positions.
On a CPU tensor it runs ``table_grad_plain``, fp32 ``index_add_`` in the
ids' order, as the library backward does on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from ctr_recommendation_tpu_torch.ops.cuda import build
from ctr_recommendation_tpu_torch.ops.cuda.interaction import stream_of

CHUNK = 128  # csrc/table_grad.cu's kChunk: sorted positions a block of pass 1 sums
MAX_IDS = 2**31 - 1 - CHUNK  # int32 positions and chunk starts
MAX_ROWS = 2**31 - 2  # int32 keys and row + 1
ENVELOPE = f"0 <= ids <= {MAX_IDS}, 1 <= rows <= {MAX_ROWS}, E >= 1"


def launches() -> int:
    """Kernel launches of one ``table_grad`` call: the chunk pass and the
    row pass."""
    return 2


def fits(n_ids: int, rows: int, e: int) -> bool:
    """Whether the kernel takes ``n_ids`` ids into a (rows, E) gradient
    (``ENVELOPE``): a pure function of the shapes, the C
    ``table_grad_fits``."""
    return 0 <= n_ids <= MAX_IDS and 1 <= rows <= MAX_ROWS and e >= 1


def check_envelope(n_ids: int, rows: int, e: int) -> None:
    """Raise unless the kernel takes these shapes (``fits``)."""
    if not fits(n_ids, rows, e):
        raise ValueError(f"table_grad needs {ENVELOPE}; got {n_ids} ids, rows={rows}, E={e}")


def table_grad_plain(ids: torch.Tensor, cot: torch.Tensor, rows: int) -> torch.Tensor:
    """zeros(rows, E).index_add_(0, ids, cot) in cot's dtype: ids (n,)
    integers in [0, rows), cot (n, E)."""
    return torch.zeros(rows, cot.shape[-1], dtype=cot.dtype, device=cot.device).index_add_(
        0, ids.to(torch.int64), cot)


_LIB = None


def _kernel_lib():
    global _LIB
    if _LIB is None:
        lib = build.load("table_grad")
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.table_grad_fits.argtypes = [ctypes.c_longlong] * 3
        lib.table_grad_fits.restype = i
        lib.table_grad_scratch.argtypes = [i, i]
        lib.table_grad_scratch.restype = ctypes.c_size_t
        lib.table_grad.argtypes = [vp] * 6 + [i] * 3 + [vp]
        lib.table_grad.restype = i
        _LIB = lib
    return _LIB


def table_grad(ids: torch.Tensor, cot: torch.Tensor, rows: int) -> torch.Tensor:
    """The gradient (rows, E) of ``table[ids]`` under cotangents ``cot``: ids
    (n,) integers in [0, rows), cot (n, E) fp32. On a card: the sort and
    ``launches()`` launches; on the CPU ``table_grad_plain``."""
    if cot.device.type == "cpu":
        return table_grad_plain(ids, cot, rows)
    if cot.device.type != "cuda" or ids.device != cot.device:
        raise ValueError(f"table_grad runs on CUDA or CPU tensors, got ids on {ids.device}, "
                         f"cot on {cot.device}")
    if cot.dtype != torch.float32 or cot.dim() != 2 or ids.dim() != 1:
        raise ValueError(f"table_grad needs ids (n,) and cot (n, E) float32; got ids "
                         f"{tuple(ids.shape)}, cot {tuple(cot.shape)} {cot.dtype}")
    if ids.dtype.is_floating_point or ids.dtype.is_complex or ids.shape[0] != cot.shape[0]:
        raise ValueError(f"table_grad: ids {tuple(ids.shape)} {ids.dtype} for cot "
                         f"{tuple(cot.shape)}")
    n, e = cot.shape
    check_envelope(n, rows, e)
    if n == 0:
        return torch.zeros(rows, e, dtype=cot.dtype, device=cot.device)
    keys, perm = torch.sort(ids.to(torch.int32), stable=True)
    cot = cot.contiguous()
    out = torch.empty(rows, e, dtype=cot.dtype, device=cot.device)
    lib = _kernel_lib()
    scratch = lib.table_grad_scratch(n, e)
    head = torch.empty(scratch, dtype=cot.dtype, device=cot.device)
    tail = torch.empty(scratch, dtype=cot.dtype, device=cot.device)
    rc = lib.table_grad(*(t.data_ptr() for t in (keys, perm, cot, out, head, tail)),
                        n, rows, e, stream_of(cot))
    build.check(rc, "table_grad")
    table_grad.launches += launches()
    return out


table_grad.launches = 0
