"""Pipelined end-to-end submission: columns -> device -> CSV + zip, overlapped.

  reader thread   parquet record-batch decode (or already-decoded column
                  chunks) -> wire-pack (data/wire.py: one uint8 buffer per
                  chunk) into pinned host memory
  main thread     upload from pinned memory, non_blocking on a side stream ->
                  unpack on the device -> score the chunk's fixed-size
                  batches (Predictor.score_batches) -> copy the
                  probabilities into pinned host memory, then record an event
  writer thread   waits on that chunk's event (not on the whole device) ->
                  appends CSV rows (the native writer, data/native, IDs
                  from the rows written so far) -> one zip at the end

Bounded queues (depth 2) keep host memory flat whatever the split size. On
a CPU predictor the same stages run without streams or events.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Iterable, Iterator

import numpy as np
import torch

from ctr_recommendation_tpu_torch.config.schema import FeatureType
from ctr_recommendation_tpu_torch.data.parquet import _pad_list_column
from ctr_recommendation_tpu_torch.data.wire import (
    build_unpacker,
    build_wire_plan,
    pack_columns,
)
from ctr_recommendation_tpu_torch.inference.submission import (
    write_csv_chunk,
    zip_submission,
)

_SENTINEL = object()


def _decode_record_batch(rb, feature_map) -> dict[str, np.ndarray]:
    """Arrow RecordBatch -> host columns (sequences padded to max_len,
    integers int32, the rest float32)."""
    spec_by_name = {f.name: f for f in feature_map.features}
    cols: dict[str, np.ndarray] = {}
    for name in rb.schema.names:
        col = rb.column(rb.schema.get_field_index(name))
        spec = spec_by_name.get(name)
        if spec is not None and spec.type == FeatureType.SEQUENCE:
            cols[name] = _pad_list_column(col, spec.max_len, spec.pad_id)
        else:
            arr = col.to_numpy(zero_copy_only=False)
            if np.issubdtype(arr.dtype, np.integer):
                arr = arr.astype(np.int32)
            else:
                arr = arr.astype(np.float32)
            cols[name] = arr
    return cols


def _parquet_chunks(path: str, fm, wanted: list[str], chunk_rows: int) -> Iterator[dict]:
    import pyarrow.parquet as pq

    pf = pq.ParquetFile(path)
    missing = [c for c in wanted if c not in set(pf.schema_arrow.names)]
    if missing:
        raise KeyError(f"{path} is missing model columns {missing}")
    for rb in pf.iter_batches(batch_size=chunk_rows, columns=wanted):
        yield _decode_record_batch(rb, fm)


def run_submission_pipeline(
    source: str | os.PathLike | Iterable[dict[str, np.ndarray]],
    predictor,
    out_dir: str,
    *,
    batch_size: int = 8192,
    chunk_rows: int = 65_536,
    csv_name: str = "prediction_fibinet.csv",
    zip_name: str = "submission_fibinet.zip",
) -> tuple[int, str, str]:
    """Stream ``source`` through the predictor into the submission CSV + zip.

    ``source`` is a parquet path (read in ``chunk_rows`` record batches) or
    an iterable of already-decoded column chunks (name -> (n,) or (n, S)
    array, in row order). Returns ``(rows_written, csv_path, zip_path)``.
    Row order, and so the ID column, follows the source; probabilities are
    identical to ``Predictor.score_table`` when chunks are whole multiples
    of ``batch_size`` (same batches, same scoring step).
    """
    fm = predictor.fm
    device = predictor.device
    on_cuda = device.type == "cuda"
    chunk_rows = max(batch_size, (chunk_rows // batch_size) * batch_size)
    plan = build_wire_plan(fm)
    wanted = [e.name for e in plan.entries]
    if isinstance(source, (str, os.PathLike)):
        chunks = _parquet_chunks(os.fspath(source), fm, wanted, chunk_rows)
    else:
        chunks = iter(source)

    os.makedirs(out_dir, exist_ok=True)
    csv_path = os.path.join(out_dir, csv_name)
    zip_path = os.path.join(out_dir, zip_name)

    q_packed: queue.Queue = queue.Queue(maxsize=2)
    q_scored: queue.Queue = queue.Queue(maxsize=2)
    errors: list[BaseException] = []

    def reader():
        try:
            for cols in chunks:
                if errors:
                    return
                n_valid = len(cols[wanted[0]])
                n_padded = -(-n_valid // batch_size) * batch_size
                buf, layout = pack_columns(cols, plan, n_padded)
                host = torch.from_numpy(buf)
                if on_cuda:
                    host = torch.empty(len(buf), dtype=torch.uint8, pin_memory=True)
                    host.numpy()[:] = buf
                q_packed.put((n_valid, host, layout))
        except BaseException as e:  # noqa: BLE001 — forwarded to main
            errors.append(e)
        finally:
            q_packed.put(_SENTINEL)

    def writer():
        try:
            written = 0
            while True:
                item = q_scored.get()
                if item is _SENTINEL:
                    break
                n_valid, probs, done = item
                if done is not None:
                    done.synchronize()  # this chunk's scoring and copy only
                write_csv_chunk(
                    probs.numpy(), csv_path, id_offset=written, append=written > 0
                )
                written += n_valid
            if written == 0:
                write_csv_chunk(np.zeros(0, np.float32), csv_path, id_offset=0, append=False)
            zip_submission(csv_path, zip_path, csv_name)
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    upload_stream = torch.cuda.Stream(device) if on_cuda else None
    t_reader = threading.Thread(target=reader, daemon=True)
    t_writer = threading.Thread(target=writer, daemon=True)
    t_reader.start()
    t_writer.start()

    def put_to_writer(item) -> bool:
        """Bounded put that cannot deadlock on a dead writer: if the writer
        has exited (its error is in ``errors``), give up so the error
        propagates."""
        while t_writer.is_alive():
            try:
                q_scored.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    total = 0
    try:
        while True:
            item = q_packed.get()
            if item is _SENTINEL or errors:
                break
            n_valid, host, layout = item
            if on_cuda:
                main = torch.cuda.current_stream(device)
                with torch.cuda.stream(upload_stream):
                    buf = host.to(device, non_blocking=True)
                main.wait_stream(upload_stream)
                buf.record_stream(main)
            else:
                buf = host
            cols = build_unpacker(layout)(buf)
            probs = predictor.score_batches(cols, batch_size)[:n_valid]
            done = None
            if on_cuda:
                out = torch.empty(n_valid, dtype=torch.float32, pin_memory=True)
                out.copy_(probs, non_blocking=True)
                done = torch.cuda.Event()
                done.record(main)
                probs = out
            if not put_to_writer((n_valid, probs, done)):
                break
            total += n_valid
    finally:
        put_to_writer(_SENTINEL)
        t_writer.join()
        # if main stopped consuming early (error path), the reader may be
        # blocked on a full q_packed: drain until it exits
        while t_reader.is_alive():
            try:
                q_packed.get_nowait()
            except queue.Empty:
                pass
            t_reader.join(timeout=0.05)
    if errors:
        raise errors[0]
    return total, csv_path, zip_path
