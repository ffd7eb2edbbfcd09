"""Online serving: request collation, dynamic micro-batching, HTTP server
(the JAX package's serving/ on the port).

The offline path scores a split in fixed batches (``Predictor.score_table``,
the pipeline). The online path scores a handful of candidate items for one
user per request, on top of the same Predictor:

* requests are collated to a FIXED menu of batch-size buckets (16 to 8192
  rows), so the card sees a handful of shapes, each warmed once;
* concurrent requests are coalesced by a micro-batcher into one dispatch, so
  the host's per-call cost (upload, launches, read-back) is shared;
* the HTTP front end is stdlib-only (no framework dependency to pin).

Latency per bucket and throughput under load on the card:
``chip_smoke.py``'s serving phase (its ``[serve ...]`` lines), recorded in
PERF.md with the card's name and power limit.
"""

from ctr_recommendation_tpu_torch.serving.collator import RequestCollator
from ctr_recommendation_tpu_torch.serving.server import (
    MicroBatcher,
    ScoringService,
    make_http_server,
)

__all__ = [
    "RequestCollator",
    "MicroBatcher",
    "ScoringService",
    "make_http_server",
]
