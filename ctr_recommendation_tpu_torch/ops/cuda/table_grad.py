"""The gradient of a gather, summed in a fixed order (csrc/table_grad.cu).

``table_grad(segments, rows)`` is ``zeros(rows, E).index_add(0, ids, cot)``
over the concatenation of ``segments``, a short list of ``(ids, cot)``
pairs: the table gradient of ``table[ids]``, ids in [0, rows); an id
outside adds nothing. It replaces no TPU kernel. It takes the place of
PyTorch's dense embedding backward (the backward of ``F.embedding``), which
on an H100 sums a row's cotangents in an order that changes from call to
call (10 calls on the same 8192 ids into 129 rows gave 9 results apart from
the first, up to 3.8e-5), so that two training runs of one seed parted.
Its callers: ``models/trunk.py::TableLookup`` (every gather's backward: the
trunk's, the merged per-table lookup's and the gathered strategy's row
buffers', one segment a feature) and ``parallel/embedding.py::
_ShardedLookup`` (the row-sharded lookup's local backward). The JAX package
takes the same function as ``jnp.zeros(...).at[ids].add(cot)``
(``training/sparse.py::multi_feature_lookup``), a fixed-order scatter on a
TPU.

On CUDA tensors the kernel reads each segment where the caller's autograd
left it: int64 ids as given, cotangent rows on up to two levels of strides
(a transposed (S, B, E) view is read without a copy; a segment is made
contiguous only where its rows sit on no such grid). Positions count
through the segments in list order, so a call on segments is the call on
their concatenation, bit for bit. ``plan(n, rows, e)``, a pure function of
the shapes mirroring the C ``table_grad_plan``, picks the path:

* shared (``rows * E * 4 <= SHARED_BYTES``): no sort; fixed slices of the
  positions summed in shared memory, each (row, column) by one thread in
  position order, then the slices' partials added in slice order (one
  launch for one slice, else two);
* sorted: the ids as int32 keys in [0, rows] sorted stably by a radix sort
  of ``DIGIT_BITS`` a pass (an ordering, not the sum: three launches a
  pass), fixed chunks of ``CHUNK`` sorted positions summed run by run,
  ``SUB`` positions a warp, the pieces added in warp order, then every row
  from its span in an O(1) table: zeros, nothing, or its chunks' partials
  added in chunk order (two launches).

No atomics: the same inputs give the same bits on every call;
``table_grad_order`` repeats that order in PyTorch on the CPU for the
tests. Bound on an H100: bytes (the ids and cotangents read once, the
gradient written once). Envelope (``fits``): any E, ids and rows that fit
int32 positions, 1 to ``MAX_SEGMENTS`` segments. On CPU tensors the wrapper
runs ``table_grad_plain``, fp32 ``index_add_`` in the positions' order, as
the library backward does on the CPU.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence

import torch

from ctr_recommendation_tpu_torch.ops.cuda import build
from ctr_recommendation_tpu_torch.ops.cuda.interaction import stream_of
from ctr_recommendation_tpu_torch.utils.profiling import span

# csrc/table_grad.cu's constants
MAX_SEGMENTS = 8  # kMaxSegments: (ids, cot) segments a call
SHARED_BYTES = 160 * 1024  # kSharedBytes: the largest table of the shared path
SLICE = 128  # kSlice: fewest positions a slice of the shared path
MAX_SLICES = 256  # kMaxSlices
SUB = 32  # kSub: sorted positions a warp of the chunk pass sums
CHUNK = 8 * SUB  # kChunk: sorted positions a block of the chunk pass sums (8 warps)
DIGIT_BITS = 9  # kDigitBits: key bits a pass of the key sort
SORT_TILE = 1024  # kSortTile: keys a block of the key sort
MAX_IDS = 2**31 - 1 - CHUNK  # int32 positions and chunk starts
MAX_ROWS = 2**31 - 2  # int32 keys and row + 1
ENVELOPE = (f"0 <= ids <= {MAX_IDS}, 1 <= rows <= {MAX_ROWS}, E >= 1, "
            f"1 <= segments <= {MAX_SEGMENTS}")

Segment = tuple[torch.Tensor, torch.Tensor]


class Plan(NamedTuple):
    """One call's path and sizes (the C ``table_grad_plan``'s six numbers)."""

    path: str  # "shared" or "sorted"
    launches: int
    blocks: int  # slices (shared) or chunks (sorted)
    slice_len: int  # positions a slice (shared), else 0
    partials: int  # floats of partial sums
    ints: int  # int32 scratch (sorted: the sort's keys and values twice, its tile
    # histograms and digit counts, the row -> span table)


def fits(n_ids: int, rows: int, e: int, segments: int = 1) -> bool:
    """Whether the kernel takes ``n_ids`` ids in ``segments`` segments into a
    (rows, E) gradient (``ENVELOPE``): a pure function of the shapes, the C
    ``table_grad_fits``."""
    return (0 <= n_ids <= MAX_IDS and 1 <= rows <= MAX_ROWS and e >= 1
            and 1 <= segments <= MAX_SEGMENTS)


def check_envelope(n_ids: int, rows: int, e: int, segments: int = 1) -> None:
    """Raise unless the kernel takes these shapes (``fits``)."""
    if not fits(n_ids, rows, e, segments):
        raise ValueError(f"table_grad needs {ENVELOPE}; got {n_ids} ids, rows={rows}, E={e}, "
                         f"{segments} segments")


def plan(n_ids: int, rows: int, e: int) -> Plan:
    """The path, launches and scratch of a call on ``n_ids`` ids into a (rows,
    E) gradient: the C ``table_grad_plan``. Raises outside ``fits``."""
    check_envelope(n_ids, rows, e)
    if rows * e * 4 <= SHARED_BYTES:
        length = 1 if n_ids == 0 else max(SLICE, -(-n_ids // MAX_SLICES))
        slices = 1 if n_ids == 0 else -(-n_ids // length)
        return Plan("shared", 2 if slices > 1 else 1, slices, length,
                    slices * rows * e if slices > 1 else 0, 0)
    chunks, tiles = -(-n_ids // CHUNK), -(-n_ids // SORT_TILE)
    passes = -(-rows.bit_length() // DIGIT_BITS)  # keys in [0, rows]
    return Plan("sorted", 3 * passes + 2 if n_ids else 1, chunks, 0, 2 * chunks * e,
                4 * n_ids + (1 << DIGIT_BITS) * (tiles + 1) + 2 * rows)


def launches(n_ids: int, rows: int, e: int) -> int:
    """Kernel launches of one ``table_grad`` call on these shapes (``plan``):
    shared, 1 for one slice, else 2; sorted, three a pass of the key sort
    (2 passes up to 2^18 - 1 rows), the chunk pass and the row pass (only
    the row pass for no ids)."""
    return plan(n_ids, rows, e).launches


def _segments(segments: Sequence[Segment]) -> tuple[list[tuple[torch.Tensor, torch.Tensor]], int]:
    """The segments as (ids (n_k,) int64, cot with ids' shape + (E,)), and E;
    raises on shapes and dtypes the function does not take."""
    if not segments:
        raise ValueError("table_grad needs at least one (ids, cot) segment")
    out, e = [], segments[0][1].shape[-1]
    for ids, cot in segments:
        if ids.dtype.is_floating_point or ids.dtype.is_complex or ids.dtype == torch.bool:
            raise ValueError(f"table_grad: ids of dtype {ids.dtype}")
        lead = cot.shape[:-1]
        if cot.shape[-1] != e or (lead != ids.shape if len(lead) > 1 else
                                  lead.numel() != ids.numel()):
            raise ValueError(f"table_grad: ids {tuple(ids.shape)} for cot {tuple(cot.shape)} "
                             f"(E={e})")
        out.append((ids.reshape(-1).to(torch.int64), cot))
    return out, e


def table_grad_plain(segments: Sequence[Segment], rows: int) -> torch.Tensor:
    """zeros(rows, E).index_add_ of each segment in turn, in cot's dtype: ids
    integers, cot ids' shape + (E,); an id outside [0, rows) adds nothing.
    On the CPU the positions are added in order, so the result is that of
    the segments' concatenation."""
    segs, e = _segments(segments)
    cot0 = segs[0][1]
    out = torch.zeros(rows, e, dtype=cot0.dtype, device=cot0.device)
    for ids, cot in segs:
        cot = cot.reshape(-1, e)
        keep = (ids >= 0) & (ids < rows)
        if not bool(keep.all()):
            ids, cot = ids[keep], cot[keep]
        out.index_add_(0, ids, cot)
    return out


def table_grad_order(segments: Sequence[Segment], rows: int) -> torch.Tensor:
    """The kernel's sum, in the kernel's order, in fp32 on the CPU (for the
    tests and chip_smoke.py's bit-for-bit check: CPU ``index_add_`` adds in
    index order). Shared path: each
    slice's rows in position order, the slices added in slice order.
    Sorted path: the ids stably sorted; each run's pieces within a warp's
    ``SUB`` positions summed in order, the pieces of a chunk of ``CHUNK``
    added in warp order, a run's chunks in chunk order."""
    segs, e = _segments(segments)
    ids = torch.cat([i.cpu() for i, _ in segs])
    cot = torch.cat([c.detach().cpu().float().reshape(-1, e) for _, c in segs])
    n = ids.numel()
    p = plan(n, rows, e)
    keep = (ids >= 0) & (ids < rows)
    if p.path == "shared":
        out = torch.zeros(rows, e)
        for s in range(p.blocks):  # one slice: out is its table, 0 + x == x
            sl = slice(s * p.slice_len, (s + 1) * p.slice_len)
            out += torch.zeros(rows, e).index_add_(0, ids[sl][keep[sl]], cot[sl][keep[sl]])
        return out
    keys = torch.where(keep, ids, rows)
    keys, perm = torch.sort(keys, stable=True)
    pos = torch.arange(n)
    new_run = torch.ones(n, dtype=torch.bool)
    new_run[1:] = keys[1:] != keys[:-1]
    # pieces: a run within one warp's SUB positions, summed in sorted order
    piece = torch.cumsum(new_run | (pos % SUB == 0), 0) - 1
    pieces = torch.zeros(int(piece[-1]) + 1 if n else 0, e).index_add_(0, piece, cot[perm])
    first = torch.ones(n, dtype=torch.bool)
    first[1:] = piece[1:] != piece[:-1]
    # a chunk's part of a run: its pieces in warp order
    part = torch.cumsum(new_run | (pos % CHUNK == 0), 0) - 1
    parts = torch.zeros(int(part[-1]) + 1 if n else 0, e).index_add_(0, part[first],
                                                                     pieces)
    head = torch.ones(n, dtype=torch.bool)
    head[1:] = part[1:] != part[:-1]
    # a run's chunks, in chunk order
    row = keys[head]
    k = row < rows
    return torch.zeros(rows, e).index_add_(0, row[k], parts[k])


_LIB = None


def _kernel_lib():
    global _LIB
    if _LIB is None:
        lib = build.load("table_grad")
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.table_grad_fits.argtypes = [ll] * 4
        lib.table_grad_fits.restype = i
        lib.table_grad_plan.argtypes = [ll] * 3 + [ctypes.POINTER(ll)]
        lib.table_grad_plan.restype = i
        lib.table_grad_shared.argtypes = [vp, i, vp, vp, ll, i, i, vp]
        lib.table_grad_shared.restype = i
        lib.table_grad_sorted.argtypes = [vp, i, vp, vp, vp, i, i, i, vp]
        lib.table_grad_sorted.restype = i
        _LIB = lib
    return _LIB


def c_plan(n_ids: int, rows: int, e: int) -> Plan | None:
    """The C ``table_grad_plan`` (the card's library), None outside fits."""
    out = (ctypes.c_longlong * 6)()
    if _kernel_lib().table_grad_plan(n_ids, rows, e, out):
        return None
    return Plan("sorted" if out[0] else "shared", *out[1:])


def _rows_grid(cot: torch.Tensor, n: int, e: int) -> tuple[torch.Tensor, int, int, int]:
    """(cot, inner, stride_outer, stride_inner): the n cotangent rows at
    (q // inner) * stride_outer + (q % inner) * stride_inner floats, each
    row's E floats contiguous. A (A, B, E) segment is read on its own two
    strides (a transposed view needs no copy); any other is read as (n, E),
    copied only where it does not merge into one."""
    if cot.stride(-1) != 1 and e > 1:
        cot = cot.contiguous()
    if cot.dim() == 3:
        return cot, max(cot.shape[1], 1), cot.stride(0), cot.stride(1)
    cot = cot.reshape(n, e)
    return cot, max(n, 1), 0, cot.stride(0)


def table_grad(segments: Sequence[Segment], rows: int) -> torch.Tensor:
    """The gradient (rows, E) of ``table[ids]`` for each (ids, cot) of
    ``segments`` under its cotangents: ids integers in [0, rows), cot fp32
    of ids' shape + (E,). On a card: ``plan``'s path, ``launches(n, rows,
    E)`` launches; on the CPU ``table_grad_plain``. The span ``table_grad``
    while a profiler runs."""
    with span("table_grad"):
        return _table_grad(segments, rows)


def _table_grad(segments: Sequence[Segment], rows: int) -> torch.Tensor:
    segs, e = _segments(segments)
    dev = segs[0][1].device
    if dev.type == "cpu" and all(c.device == dev and i.device == dev for i, c in segs):
        return table_grad_plain(segments, rows)
    if dev.type != "cuda" or any(c.device != dev or i.device != dev for i, c in segs):
        raise ValueError(f"table_grad runs on CUDA or CPU tensors, all on one device; got "
                         f"{sorted({str(t.device) for s in segs for t in s})}")
    if any(c.dtype != torch.float32 for _, c in segs):
        raise ValueError(f"table_grad needs float32 cotangents; got "
                         f"{[c.dtype for _, c in segs]}")
    n = sum(i.numel() for i, _ in segs)
    k = len(segs)
    check_envelope(n, rows, e, k)
    p = plan(n, rows, e)
    lib = _kernel_lib()
    keep, table = [], []  # the tensors the kernel reads (alive through the call), its table
    for ids, cot in segs:
        cot, inner, so, si = _rows_grid(cot, ids.numel(), e)
        keep.append(cot)
        table += [ids.data_ptr(), cot.data_ptr(), ids.numel(), inner, so, si]
    seg = (ctypes.c_longlong * (6 * k))(*table)
    stream = stream_of(keep[0])
    out = torch.empty(rows, e, dtype=torch.float32, device=dev)
    part = torch.empty(p.partials, dtype=torch.float32, device=dev)
    if p.path == "shared":
        rc = lib.table_grad_shared(seg, k, out.data_ptr(), part.data_ptr(), n, rows, e, stream)
    else:
        ints = torch.empty(p.ints, dtype=torch.int32, device=dev)
        rc = lib.table_grad_sorted(seg, k, out.data_ptr(), part.data_ptr(), ints.data_ptr(), n,
                                   rows, e, stream)
    build.check(rc, "table_grad")
    table_grad.launches += p.launches
    return out


table_grad.launches = 0
