"""Online scoring service: micro-batcher + stdlib HTTP front end (the JAX
package's serving/server.py on the port).

Request flow::

    HTTP POST /v1/score {"rows": [...]}     (any number of concurrent clients)
        -> MicroBatcher.submit(rows)        (queue + Future)
            -> the batcher thread coalesces queued requests up to max_batch
               rows or max_wait_ms after the first arrival
            -> RequestCollator pads to a fixed bucket
            -> Predictor (BN-folded; on the fused branch the scoring kernel)
            -> the scores read back to the host (.cpu(): the dispatch's sync)
        <- per-request probability slices

The batcher thread launches the kernels: one merged dispatch serves every
request that arrived within the window, so the per-call host cost of the
upload, the launches and the read-back is paid once per dispatch, not once
per request.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from ctr_recommendation_tpu_torch.config.schema import FeatureType
from ctr_recommendation_tpu_torch.serving.collator import RequestCollator


def to_host(probs) -> np.ndarray:
    """A predictor's scores as host float32. The port's Predictor returns a
    tensor on its device; ``.cpu()`` copies it back, the sync JAX's
    ``np.asarray`` makes, so a failed launch raises here. numpy passes
    through."""
    if isinstance(probs, torch.Tensor):
        probs = probs.cpu()
    return np.asarray(probs, np.float32)


class MicroBatcher:
    """Coalesce concurrent scoring requests into single device dispatches."""

    def __init__(
        self,
        predictor,
        collator: RequestCollator,
        *,
        max_wait_ms: float = 2.0,
        name: str = "scoring-batcher",
    ):
        self.predictor = predictor
        self.collator = collator
        self.max_wait_s = max_wait_ms / 1000.0
        self._queue: queue.Queue = queue.Queue()
        self._closed = False
        # observability counters (exposed by /v1/stats)
        self.requests_served = 0
        self.rows_scored = 0
        self.batches_dispatched = 0
        self.coalesced_batches = 0  # dispatches that served >1 request
        self._thread = threading.Thread(target=self._run, name=name, daemon=True)
        self._thread.start()

    def submit(self, rows: list[dict]) -> list[float]:
        """Score ``rows``; blocks until the coalesced dispatch completes.

        Oversized requests are split across buckets transparently.
        """
        if self._closed:
            raise RuntimeError("batcher is closed")
        if not rows:
            raise ValueError("empty request: no rows to score")
        out: list[float] = []
        mb = self.collator.max_batch
        for start in range(0, len(rows), mb):
            chunk = rows[start : start + mb]
            fut: Future = Future()
            self._queue.put((chunk, fut))
            out.extend(fut.result())
        return out

    def close(self) -> None:
        self._closed = True
        self._queue.put(None)
        self._thread.join(timeout=5)
        # A request that squeezed past the _closed check but was enqueued
        # after the sentinel was consumed would block its caller forever:
        # fail its Future instead of stranding it.
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                item[1].set_exception(RuntimeError("batcher is closed"))

    def _run(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                return
            pending = [item]
            n_rows = len(item[0])
            # linger up to max_wait_s for co-arriving requests, stop at a
            # full bucket (later arrivals form the next dispatch)
            deadline = time.monotonic() + self.max_wait_s
            while n_rows < self.collator.max_batch:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=timeout)
                except queue.Empty:
                    break
                if nxt is None:
                    self._dispatch(pending)
                    return
                if n_rows + len(nxt[0]) > self.collator.max_batch:
                    self._dispatch(pending)
                    pending, n_rows = [nxt], len(nxt[0])
                    deadline = time.monotonic() + self.max_wait_s
                else:
                    pending.append(nxt)
                    n_rows += len(nxt[0])
            self._dispatch(pending)

    def _dispatch(self, pending: list[tuple[list[dict], Future]]) -> None:
        """Validate each request chunk on its own, group the survivors by
        dense-column signature, and run one device dispatch per group.

        Coalescing must never contaminate independent requests: a malformed
        chunk (bad dense_dim, non-dict row, out-of-range id) fails ONLY its
        own Future, and a chunk that supplies ``item_emb_d128`` client-side
        never merges with one relying on the server join (the collator's
        all-or-none dense rule would otherwise fail both, depending on
        arrival timing)."""
        if not pending:
            return
        groups: dict[frozenset, list[tuple[list[dict], Future]]] = {}
        for chunk, fut in pending:
            try:
                sig = self.collator.validate_chunk(chunk)
            except Exception as e:  # fail the offender, spare its neighbors
                fut.set_exception(e)
                continue
            groups.setdefault(sig, []).append((chunk, fut))
        for grp in groups.values():
            rows = [r for chunk, _ in grp for r in chunk]
            try:
                batch, n = self.collator.collate(rows)
                probs = to_host(self.predictor(batch))[:n]
            except Exception as e:  # surface per request (HTTP 500), keep the thread alive
                for _, fut in grp:
                    fut.set_exception(e)
                continue
            self.batches_dispatched += 1
            self.coalesced_batches += len(grp) > 1
            self.requests_served += len(grp)
            self.rows_scored += n
            off = 0
            for chunk, fut in grp:
                fut.set_result(probs[off : off + len(chunk)].tolist())
                off += len(chunk)


class ScoringService:
    """The servable unit: model metadata + a MicroBatcher."""

    def __init__(
        self,
        predictor,
        feature_map,
        *,
        model_name: str,
        buckets=None,
        max_wait_ms: float = 2.0,
    ):
        kw = {} if buckets is None else {"buckets": tuple(buckets)}
        self.collator = RequestCollator(feature_map, **kw)
        self.batcher = MicroBatcher(predictor, self.collator, max_wait_ms=max_wait_ms)
        self.model_name = model_name

    def score(self, rows: list[dict]) -> list[float]:
        return self.batcher.submit(rows)

    def warmup(self) -> None:
        """Run every bucket shape once, on the caller's thread, before the
        first request: on the card the first call builds and loads the
        kernels, and each new shape sets up its allocations.

        Each bucket has TWO batch structures: the no-dense one (the device
        join fills ``item_emb_d128`` & co from the id column) and the one
        where the client ships the dense vectors; both are warmed."""
        protos: list[dict] = [{}]
        dense = {
            f.name: [0.0] * f.dense_dim
            for f in self.collator.features
            if f.type == FeatureType.DENSE_EMBEDDING
        }
        if dense:
            protos.append(dense)  # all dense columns supplied client-side
        for b in self.collator.buckets:
            for proto in protos:
                batch, _ = self.collator.collate([dict(proto) for _ in range(b)])
                to_host(self.batcher.predictor(batch))

    def info(self) -> dict:
        return {
            "model": self.model_name,
            "fields": list(self.collator.fm.field_names),
            "buckets": list(self.collator.buckets),
            "max_batch": self.collator.max_batch,
        }

    def stats(self) -> dict:
        b = self.batcher
        return {
            "requests_served": b.requests_served,
            "rows_scored": b.rows_scored,
            "batches_dispatched": b.batches_dispatched,
            "coalesced_batches": b.coalesced_batches,
        }

    def close(self) -> None:
        self.batcher.close()


class _Server(ThreadingHTTPServer):
    # the listen backlog: the stdlib's 5 overflows when a few dozen clients
    # connect at once, and the kernel then resets connections or makes a
    # client retry its SYN a second later
    request_queue_size = 1024


def make_http_server(
    service: ScoringService, host: str = "127.0.0.1", port: int = 0
) -> ThreadingHTTPServer:
    """Build (not start) a threaded HTTP server over ``service``.

    Endpoints: GET /healthz, GET /v1/model, GET /v1/stats,
    POST /v1/score with body {"rows": [{feature: value, ...}, ...]}
    (or {"instances": [...]}) -> {"probs": [...]}. A malformed request
    gets 400, any other failure 500.
    """

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (stdlib API)
            if self.path == "/healthz":
                self._reply(200, {"status": "ok", "model": service.model_name})
            elif self.path == "/v1/model":
                self._reply(200, service.info())
            elif self.path == "/v1/stats":
                self._reply(200, service.stats())
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):  # noqa: N802
            if self.path != "/v1/score":
                self._reply(404, {"error": f"unknown path {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(length) or b"{}")
                rows = payload.get("rows", payload.get("instances"))
                if not isinstance(rows, list) or not rows:
                    raise ValueError('body must be {"rows": [{feature: value, ...}, ...]}')
                probs = service.score(rows)
            except (
                ValueError,
                TypeError,
                KeyError,
                AttributeError,
                json.JSONDecodeError,
            ) as e:
                self._reply(400, {"error": str(e)})
                return
            except Exception as e:  # never drop the connection on a request
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})
                return
            self._reply(200, {"probs": probs})

        def log_message(self, fmt, *args):  # quiet: the CLI logs stats
            pass

    return _Server((host, port), Handler)
