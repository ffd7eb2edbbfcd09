"""The port's serving package against the JAX package's (CPU).

* The counterparts of tests/test_serving.py's eight cases (out-of-range
  categorical and sequence ids, non-dict rows, a hashed table accepting any
  id, a malformed chunk failing alone, grouping by dense signature,
  ``close()`` draining stragglers, HTTP 400 on non-dict rows, warmup
  touching both batch structures of every bucket) and of
  tests/test_serving_load.py's concurrent clients coalescing.
* ``RequestCollator.collate`` equal to the JAX collate array for array, and
  ``data/parquet.py::_pad_sequences`` equal to JAX's.
* The batcher reading a tensor predictor back to the host, and a failing
  predictor failing its dispatch's requests (HTTP 500) without killing the
  batcher thread.
* Parity: the port's ScoringService over HTTP (the port's Predictor on the
  CPU, weights bridged from a JAX init whose BatchNorm state has moved)
  against the JAX ScoringService over HTTP on the same requests (ragged
  sizes crossing buckets, with and without client dense vectors), for
  mm_fibinet and sasrec_fibinet: rtol 1e-4, atol 1e-5 in fp32; atol 2e-2 in
  bf16 (tests/test_torch_predictor.py's bars).
"""

import json
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from ctr_recommendation_tpu.config import serialize as jax_serialize
from ctr_recommendation_tpu.config.schema import DatasetConfig as JaxDatasetConfig
from ctr_recommendation_tpu.config.schema import FeatureSpec as JaxFeatureSpec
from ctr_recommendation_tpu.config.schema import FeatureType as JaxFeatureType
from ctr_recommendation_tpu.data.parquet import _pad_sequences as jax_pad_sequences
from ctr_recommendation_tpu.features import build_feature_map as jax_build_fm
from ctr_recommendation_tpu.serving import RequestCollator as JaxRequestCollator
from ctr_recommendation_tpu.serving import ScoringService as JaxScoringService
from ctr_recommendation_tpu.serving import make_http_server as jax_make_http_server
from ctr_recommendation_tpu_torch.config import serialize as pt_serialize
from ctr_recommendation_tpu_torch.config.schema import DatasetConfig, FeatureSpec, FeatureType
from ctr_recommendation_tpu_torch.data.parquet import _pad_sequences
from ctr_recommendation_tpu_torch.features import build_feature_map
from ctr_recommendation_tpu_torch.features.hashing import hash_ids
from ctr_recommendation_tpu_torch.serving import (
    MicroBatcher,
    RequestCollator,
    ScoringService,
    make_http_server,
)
from tests.conftest import make_batch

torch.set_num_threads(2)

WAIT_S = 30  # every Future, join and HTTP call in this file is bounded


@pytest.fixture(scope="module")
def fm(tiny_experiment):
    """The tiny experiment's feature map, built by the port."""
    return build_feature_map(
        pt_serialize.from_json(jax_serialize.to_json(tiny_experiment)).dataset)


@pytest.fixture
def collator(fm):
    return RequestCollator(fm, buckets=(4, 16, 64))


class FakePredictor:
    """prob = item_id / 1000, with an optional dwell as a device dispatch."""

    def __init__(self, delay_s: float = 0.0):
        self.delay_s = delay_s
        self.calls = 0

    def __call__(self, batch):
        self.calls += 1
        if self.delay_s:
            time.sleep(self.delay_s)
        return batch["item_id"].astype(np.float32) / 1000.0


def _submit_all(mb, requests: dict) -> dict:
    """Submit each request from its own thread; name -> probs or exception."""
    results: dict[str, object] = {}

    def call(name, rows):
        try:
            results[name] = mb.submit(rows)
        except Exception as e:  # noqa: BLE001 - recorded for the asserts
            results[name] = e

    threads = [threading.Thread(target=call, args=item) for item in requests.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT_S)
        assert not t.is_alive()
    return results


class _Serving:
    """A service's HTTP server on a thread (port 0), shut down on exit."""

    def __init__(self, service, make=make_http_server):
        self.service = service
        self.server = make(service, port=0)
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.server.shutdown()
        self.server.server_close()
        self.service.close()
        self.thread.join(timeout=WAIT_S)
        assert not self.thread.is_alive()

    def post(self, payload) -> tuple[int, dict]:
        req = urllib.request.Request(
            f"http://127.0.0.1:{self.server.server_address[1]}/v1/score",
            data=json.dumps(payload).encode(), headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=WAIT_S) as resp:
                return resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    def get(self, path: str) -> dict:
        url = f"http://127.0.0.1:{self.server.server_address[1]}{path}"
        with urllib.request.urlopen(url, timeout=WAIT_S) as resp:
            return json.loads(resp.read())


# ------------------------------------------- tests/test_serving.py's cases
def test_collate_rejects_out_of_range_categorical(collator):
    # tiny fixture: item vocab 200, cate vocab 11 (non-hashed tables); the
    # port pads its tables to 128-row multiples, the check reads the vocab
    with pytest.raises(ValueError, match="item_id.*outside"):
        collator.collate([{"item_id": 200}])
    with pytest.raises(ValueError, match="likes_level.*outside"):
        collator.collate([{"item_id": 3, "likes_level": 11}])
    with pytest.raises(ValueError, match="item_id.*outside"):
        collator.collate([{"item_id": -1}])


def test_collate_rejects_out_of_range_sequence_id(collator):
    with pytest.raises(ValueError, match="item_seq.*outside"):
        collator.collate([{"item_id": 3, "item_seq": [1, 2, 999]}])


def test_collate_rejects_non_dict_row(collator):
    with pytest.raises(ValueError, match="row 1: expected an object"):
        collator.collate([{"item_id": 3}, 7])


def _hashed(spec, dataset, ftype):
    return dataset(
        dataset_id="hashed",
        features=(
            spec(name="item_id", type=ftype.CATEGORICAL, hash_buckets=64),
            spec(name="item_seq", type=ftype.SEQUENCE, share_embedding="item_id", max_len=4),
            spec(name="label", type=ftype.LABEL),
        ),
        data_root="",
        label="label",
    )


def test_hashed_table_accepts_any_id():
    """Hashed tables hash raw ids on the device: no range check applies,
    and the ids wrap to the int32 bit pattern of their uint32, as JAX's
    collate wraps them; the port's hash reads them back as that uint32."""
    c = RequestCollator(build_feature_map(_hashed(FeatureSpec, DatasetConfig, FeatureType)),
                        buckets=(4,))
    jc = JaxRequestCollator(
        jax_build_fm(_hashed(JaxFeatureSpec, JaxDatasetConfig, JaxFeatureType)), buckets=(4,))
    rows = [{"item_id": 10**12, "item_seq": [-1, 2**31, 2**32 + 5]},
            {"item_id": -(2**40) - 3, "item_seq": [7] * 9}]
    batch, n = c.collate(rows)
    want, _ = jc.collate(rows)
    assert n == 2 and batch["item_id"][0] == np.int64(10**12).astype(np.uint32).astype(np.int32)
    assert batch.keys() == want.keys()
    for k in want:
        assert batch[k].dtype == want[k].dtype
        np.testing.assert_array_equal(batch[k], want[k])
    hashed = hash_ids(torch.from_numpy(batch["item_id"][:1]), 64)
    raw = hash_ids(torch.tensor([10**12 % 2**32]), 64)
    assert hashed.tolist() == raw.tolist()


def test_dispatch_isolates_malformed_chunk(collator):
    """A bad request coalesced with good ones fails alone."""
    mb = MicroBatcher(FakePredictor(), collator, max_wait_ms=50.0)
    try:
        results = _submit_all(mb, {"good": [{"item_id": 5}], "bad": [{"item_id": 9999}],
                                   "good2": [{"item_id": 7}]})
        assert isinstance(results["bad"], ValueError)
        assert results["good"] == pytest.approx([0.005])
        assert results["good2"] == pytest.approx([0.007])
    finally:
        mb.close()


def test_dispatch_groups_by_dense_signature(collator, fm):
    """One request shipping item_emb_d128 and one relying on the server
    join both succeed when they co-arrive (grouped dispatches)."""
    mm_dim = next(f.dense_dim for f in fm.features if f.type == FeatureType.DENSE_EMBEDDING)
    mb = MicroBatcher(FakePredictor(delay_s=0.01), collator, max_wait_ms=60.0)
    try:
        results = _submit_all(mb, {
            "dense": [{"item_id": 5, "item_emb_d128": [0.0] * mm_dim}],
            "join": [{"item_id": 7}],
        })
        assert results["dense"] == pytest.approx([0.005])
        assert results["join"] == pytest.approx([0.007])
    finally:
        mb.close()


def test_close_drains_stragglers(collator):
    """A submit racing close() errors out instead of blocking forever."""
    mb = MicroBatcher(FakePredictor(), collator, max_wait_ms=1.0)
    mb.close()
    fut: Future = Future()
    mb._queue.put(([{"item_id": 1}], fut))  # simulate the lost race
    mb.close()  # idempotent; drains the stranded item
    with pytest.raises(RuntimeError, match="closed"):
        fut.result(timeout=1)
    with pytest.raises(RuntimeError, match="closed"):
        mb.submit([{"item_id": 1}])


def test_http_400_on_non_dict_rows(fm):
    """{"rows": [1, 2]} gets a JSON 400, not a dropped connection; a
    well-formed request still works; the GET endpoints answer."""
    svc = ScoringService(FakePredictor(), fm, model_name="fake", buckets=(4,), max_wait_ms=1.0)
    with _Serving(svc) as s:
        code, body = s.post({"rows": [1, 2]})
        assert code == 400 and "expected an object" in body["error"]
        assert s.post({"rows": []})[0] == 400
        assert s.post({"instances": [{"item_id": 5}]}) == (200, {"probs": [pytest.approx(0.005)]})
        assert s.get("/healthz") == {"status": "ok", "model": "fake"}
        assert s.get("/v1/model")["buckets"] == [4]
        assert s.get("/v1/stats")["requests_served"] == 1


def test_http_server_takes_many_clients_at_once(fm):
    """64 clients connecting in the same instant all get 200: the listen
    backlog holds them (the stdlib's 5 resets connections or delays them by
    a SYN retry of a second)."""
    svc = ScoringService(FakePredictor(), fm, model_name="fake", buckets=(64,), max_wait_ms=5.0)
    n = 64
    gate = threading.Barrier(n)
    replies: list = [None] * n
    with _Serving(svc) as s:
        assert s.post({"rows": [{"item_id": 1}]})[0] == 200  # first-use costs off the clock

        def client(i):
            gate.wait(timeout=WAIT_S)
            t = time.perf_counter()
            replies[i] = (*s.post({"rows": [{"item_id": i}]}), time.perf_counter() - t)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT_S)
            assert not t.is_alive()
    assert [r[:2] for r in replies] == [(200, {"probs": [pytest.approx(i / 1000)]})
                                        for i in range(n)]
    assert max(r[2] for r in replies) < 0.9  # no client waited out a SYN retry


def test_warmup_compiles_dense_variant(fm):
    """warmup() touches both batch structures of every bucket: with and
    without client-supplied dense columns."""
    seen: list[frozenset] = []

    def spy(batch):
        seen.append(frozenset(k for k in batch if k != "__weight__"))
        return torch.zeros(len(batch["item_id"]))

    svc = ScoringService(spy, fm, model_name="fake", buckets=(4, 16), max_wait_ms=1.0)
    try:
        svc.warmup()
    finally:
        svc.close()
    with_dense = [s for s in seen if "item_emb_d128" in s]
    without = [s for s in seen if "item_emb_d128" not in s]
    assert len(with_dense) == 2 and len(without) == 2  # one per bucket


# ------------------------------------- tests/test_serving_load.py's case
class DwellPredictor:
    """A device dispatch with a fixed dwell; records the batch sizes."""

    def __init__(self, dwell_s: float):
        self.dwell_s = dwell_s
        self.batch_rows: list[int] = []
        self._lock = threading.Lock()

    def __call__(self, batch):
        time.sleep(self.dwell_s)
        n = len(batch["item_id"])
        with self._lock:
            self.batch_rows.append(n)
        return torch.full((n,), 0.5)


def test_concurrent_clients_coalesce(fm):
    """16 clients x 8 sequential requests against a 2 ms dwell: while one
    dispatch dwells, later arrivals pile up and the next dispatch merges
    them, so requests a dispatch exceed 1."""
    predictor = DwellPredictor(dwell_s=0.002)
    mb = MicroBatcher(predictor, RequestCollator(fm, buckets=(256,)), max_wait_ms=1.0)
    n_clients, n_reqs, rows_per_req = 16, 8, 4
    errors: list[Exception] = []
    latencies: list[float] = []
    lock = threading.Lock()

    def client(cid: int):
        rng = np.random.default_rng(cid)
        for _ in range(n_reqs):
            rows = [{"item_id": int(rng.integers(1, 200)), "likes_level": 3}
                    for _ in range(rows_per_req)]
            t0 = time.monotonic()
            try:
                assert len(mb.submit(rows)) == rows_per_req
            except Exception as e:  # noqa: BLE001 - re-raised by the test body
                with lock:
                    errors.append(e)
                return
            with lock:
                latencies.append(time.monotonic() - t0)

    try:
        threads = [threading.Thread(target=client, args=(c,)) for c in range(n_clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT_S)
            assert not t.is_alive()
        assert not errors, errors[0]
        assert len(latencies) == n_clients * n_reqs
        served = mb.requests_served
        assert served == n_clients * n_reqs
        assert mb.rows_scored == served * rows_per_req
        assert mb.batches_dispatched < served, (mb.batches_dispatched, served)
        assert len(predictor.batch_rows) == mb.batches_dispatched  # one call a dispatch
        assert mb.coalesced_batches >= 1
        assert float(np.percentile(latencies, 99)) < 2.0
    finally:
        mb.close()


# ------------------------------------------------- the port's own cases
def test_batcher_reads_back_a_tensor_predictor(collator):
    """The port's Predictor returns a tensor on its device: the batcher
    copies it to the host. A failing predictor fails its dispatch's
    requests with its own error and the thread serves the next one."""
    calls = []

    def tensor_predictor(batch):
        calls.append(len(batch["item_id"]))
        if batch["item_id"][0] == 13:
            raise RuntimeError("CUDA error: an illegal memory access was encountered")
        return torch.from_numpy(batch["item_id"]).to(torch.float32) / 1000

    mb = MicroBatcher(tensor_predictor, collator, max_wait_ms=1.0)
    try:
        got = mb.submit([{"item_id": 5}, {"item_id": 9}])
        assert got == pytest.approx([0.005, 0.009]) and all(type(p) is float for p in got)
        with pytest.raises(RuntimeError, match="illegal memory access"):
            mb.submit([{"item_id": 13}])
        assert mb.submit([{"item_id": 6}]) == pytest.approx([0.006])
        assert calls == [4, 4, 4] and mb.batches_dispatched == 2
    finally:
        mb.close()

    svc = ScoringService(tensor_predictor, collator.fm, model_name="fake", buckets=(4,))
    with _Serving(svc) as s:
        code, body = s.post({"rows": [{"item_id": 13}]})
        assert code == 500 and body["error"].startswith("RuntimeError: CUDA error")
        assert s.post({"rows": [{"item_id": 6}]}) == (200, {"probs": [pytest.approx(0.006)]})


def _request_rows(rng, n: int, dense: bool) -> list[dict]:
    """Seeded rows with missing fields, histories empty, absent, short and
    longer than max_len (8), all-or-none dense vectors."""
    rows = []
    for i in range(n):
        r = {"item_id": int(rng.integers(0, 200))}
        if i % 3:
            r["likes_level"] = int(rng.integers(0, 11))
        if i % 4:
            r["views_level"] = int(rng.integers(0, 11))
        if i % 5:
            r["item_seq"] = rng.integers(0, 200, int(rng.integers(0, 13))).tolist()
        if dense:
            r["item_emb_d128"] = rng.normal(size=24).astype(np.float32).tolist()
        rows.append(r)
    return rows


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("n", [1, 4, 5, 64])
def test_collate_matches_jax(fm, tiny_feature_map, n, dense):
    rows = _request_rows(np.random.default_rng(n), n, dense)
    batch, got_n = RequestCollator(fm, buckets=(4, 16, 64)).collate(rows)
    want, want_n = JaxRequestCollator(tiny_feature_map, buckets=(4, 16, 64)).collate(rows)
    assert got_n == want_n == n
    assert batch.keys() == want.keys() and ("item_emb_d128" in batch) == dense
    for k in want:
        assert batch[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(batch[k], want[k])


@pytest.mark.parametrize("max_len, pad_id", [(8, 0), (3, 0), (5, 7)])
def test_pad_sequences_matches_jax(max_len, pad_id):
    seqs = [[], [1], list(range(1, 12)), np.arange(4, dtype=np.int32), [2**31 - 1, -5], []]
    got = _pad_sequences(seqs, max_len, pad_id)
    want = jax_pad_sequences(seqs, max_len, pad_id)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------ parity with the JAX service
BUCKETS = (4, 16, 64)
SIZES = (1, 3, 5, 16, 17, 38)  # each bucket and past its boundary


def _rows_of(batch, start: int, n: int, vectors=None) -> list[dict]:
    """Rows ``start:start + n`` of ``batch`` as request rows; with
    ``vectors`` (a row's item vector each) the client ships them."""
    rows = []
    for i in range(start, start + n):
        r = {k: int(batch[k][i]) for k in ("user_id", "likes_level", "views_level", "item_id")}
        r["item_seq"] = batch["item_seq"][i].tolist()
        if vectors is not None:
            r["item_emb_d128"] = vectors[i].tolist()
        rows.append(r)
    return rows


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
@pytest.mark.parametrize("model", ["mm_fibinet", "sasrec_fibinet"])
def test_service_over_http_matches_the_jax_service(tiny_experiment, tiny_feature_map, model,
                                                   precision):
    from ctr_recommendation_tpu.data import ItemStore as JaxItemStore
    from ctr_recommendation_tpu.inference import Predictor as JaxPredictor
    from ctr_recommendation_tpu_torch.inference import Predictor
    from tests.test_torch_predictor import _item_store, rank_corr
    from tests.test_torch_predictor import _setup as mm_setup
    from tests.test_torch_sasrec import _setup as sasrec_setup

    if model == "mm_fibinet":
        exp, params, state, pexp, pparams, pstate = mm_setup(
            tiny_experiment, tiny_feature_map, "all", precision)
    else:
        exp, _, params, state, pexp, pparams, pstate = sasrec_setup(
            tiny_experiment, tiny_feature_map, precision=precision)
    batch = make_batch(np.random.default_rng(9), sum(SIZES))
    batch["item_seq"][:2] = 0  # all-pad histories
    store = _item_store(batch)
    jpred = JaxPredictor(exp, params, state, item_store=JaxItemStore(store.emb, store.known_mask))
    pred = Predictor(pexp, pparams, pstate, device="cpu", item_store=store)
    assert pred.use_fused
    want, got = {}, {}
    with _Serving(JaxScoringService(jpred, tiny_feature_map, model_name=model, buckets=BUCKETS),
                  make=jax_make_http_server) as jax_side, \
            _Serving(ScoringService(pred, build_feature_map(pexp.dataset), model_name=model,
                                    buckets=BUCKETS)) as port_side:
        for dense in (False, True):
            start = 0
            for n in SIZES:
                rows = _rows_of(batch, start, n, store.emb[batch["item_id"]] if dense else None)
                start += n
                for side, out in ((jax_side, want), (port_side, got)):
                    code, body = side.post({"rows": rows})
                    assert code == 200, body
                    out.setdefault(dense, []).extend(body["probs"])
        assert port_side.get("/v1/stats") == {
            "requests_served": 2 * len(SIZES), "rows_scored": 2 * sum(SIZES),
            "batches_dispatched": 2 * len(SIZES), "coalesced_batches": 0}
    for dense in (False, True):
        g, w = np.asarray(got[dense], np.float32), np.asarray(want[dense], np.float32)
        assert g.shape == (sum(SIZES),)
        if precision == "float32":
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)
        else:
            np.testing.assert_allclose(g, w, atol=2e-2)
            assert rank_corr(g, w) > 0.995
    # the client ships the item store's vectors: the join's scores exactly
    np.testing.assert_array_equal(got[True], got[False])
    # each request's scores are those of the same rows in one plain call
    cols = {k: v for k, v in batch.items() if k != "item_emb_d128"}
    np.testing.assert_allclose(got[False], pred(cols).numpy(), rtol=1e-5, atol=1e-6)
