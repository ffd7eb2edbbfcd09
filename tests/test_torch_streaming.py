"""The port's host-side batch streams against the JAX package's, on the CPU.

The same seeded data (a split in the tiny experiment's schema, written to a
parquet of several uneven row groups) goes through the JAX function and its
counterpart in the port, and every batch must be EXACTLY equal, key for key,
dtype and value:

* ``iter_batches``: shuffle on and off, epochs 0 and 1, ``drop_last``,
  ``pad_final``, the host item join (and strict mode raising on the same
  input), ``TableData.shard`` over 2 hosts;
* ``stream_batches``: shuffle on and off, epochs 0 and 1, 2 hosts with both
  indices, ``drop_last``, the host join, ``include_label=False``;
  ``common_step_count``; ``window_batches`` fed numpy record batches yields
  ``stream_batches``' batches;
* ``prefetch``: order kept, a worker's exception raised in the consumer, an
  early close stopping the worker.
"""

import threading
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from ctr_recommendation_tpu.config import serialize as jax_serialize
from ctr_recommendation_tpu.data import ItemStore as JaxItemStore
from ctr_recommendation_tpu.data import iter_batches as jax_iter_batches
from ctr_recommendation_tpu.data import streaming as jax_streaming
from ctr_recommendation_tpu.data.parquet import TableData as JaxTableData
from ctr_recommendation_tpu.data.parquet import load_split as jax_load_split
from ctr_recommendation_tpu.features import build_feature_map as jax_build_fm
from ctr_recommendation_tpu_torch.config import serialize as pt_serialize
from ctr_recommendation_tpu_torch.data import ItemStore, TableData, iter_batches, prefetch
from ctr_recommendation_tpu_torch.data import streaming
from ctr_recommendation_tpu_torch.data.synthetic import make_synthetic_tables
from ctr_recommendation_tpu_torch.features import build_feature_map as pt_build_fm

torch.set_num_threads(2)

N_ROWS = 700
ROW_GROUP = 97  # 8 groups, the last of 21 rows


@pytest.fixture(scope="module")
def data(tmp_path_factory, tiny_experiment):
    """(parquet path, columns, the port's and JAX's feature maps, the two
    item stores; item 7 left out of item_info)."""
    rows, info = make_synthetic_tables(num_rows=N_ROWS, num_items=199, max_len=8, mm_dim=24,
                                       num_users=100, seed=3)
    seqs = rows["item_seq"]
    offsets = np.zeros(len(seqs) + 1, np.int64)
    np.cumsum([len(q) for q in seqs], out=offsets[1:])
    table = {k: pa.array(rows[k]) for k in ("user_id", "likes_level", "views_level", "item_id")}
    table["item_seq"] = pa.LargeListArray.from_arrays(pa.array(offsets),
                                                      pa.array(np.concatenate(seqs)))
    table["label"] = pa.array(rows["label"].astype(np.float32))
    table["extra"] = pa.array(np.arange(N_ROWS))  # no feature reads it: projected away
    path = str(tmp_path_factory.mktemp("stream") / "train.parquet")
    pq.write_table(pa.table(table), path, row_group_size=ROW_GROUP)
    assert pq.ParquetFile(path).num_row_groups == 8
    pexp = pt_serialize.from_json(jax_serialize.to_json(tiny_experiment))
    jax_fm = jax_build_fm(tiny_experiment.dataset)
    cols = jax_load_split(path, jax_fm).columns
    keep = np.asarray(info["item_id"]) != 7
    ids = np.asarray(info["item_id"])[keep]
    emb = np.asarray(info["item_emb_d128"], np.float32)[keep]
    return {"path": path, "cols": cols, "pt_fm": pt_build_fm(pexp.dataset),
            "jax_fm": jax_fm,
            "pt_store": ItemStore.from_arrays(ids, emb),
            "jax_store": JaxItemStore.from_arrays(ids, emb)}


def assert_same_batches(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


# ------------------------------------------------------------ iter_batches
@pytest.mark.parametrize("shuffle, epoch, drop_last, pad_final, join", [
    (False, 0, False, True, False),
    (True, 0, False, True, False),
    (True, 1, False, True, True),
    (True, 1, True, True, False),
    (False, 0, False, False, True),
    (True, 0, False, False, False),
])
def test_iter_batches_match_jax(data, shuffle, epoch, drop_last, pad_final, join):
    kw = dict(shuffle=shuffle, seed=5, epoch=epoch, drop_last=drop_last, pad_final=pad_final)
    got = iter_batches(TableData(dict(data["cols"]), N_ROWS), data["pt_fm"], 64,
                       item_store=data["pt_store"] if join else None, **kw)
    want = jax_iter_batches(JaxTableData(dict(data["cols"]), N_ROWS), data["jax_fm"], 64,
                            item_store=data["jax_store"] if join else None, **kw)
    assert_same_batches(got, want)


@pytest.mark.parametrize("index", [0, 1])
def test_shard_and_take_match_jax(data, index):
    got = TableData(dict(data["cols"]), N_ROWS).shard(index, 2)
    want = JaxTableData(dict(data["cols"]), N_ROWS).shard(index, 2)
    assert got.num_rows == want.num_rows == N_ROWS // 2
    idx = np.array([3, 0, 3, 17])
    assert_same_batches([got.take(idx)], [want.take(idx)])
    assert_same_batches(
        iter_batches(got, data["pt_fm"], 64, shuffle=True, seed=1, epoch=1),
        jax_iter_batches(want, data["jax_fm"], 64, shuffle=True, seed=1, epoch=1))


def test_strict_join_raises_as_jax(data):
    """Item 7 is not in item_info: strict mode raises the same KeyError on
    the batch that holds it, tolerant mode joins zeros."""
    cols = dict(data["cols"])
    cols["item_id"] = cols["item_id"].copy()
    cols["item_id"][130] = 7

    def first_error(batches):
        with pytest.raises(KeyError) as e:
            for _ in batches:
                pass
        return str(e.value)

    kw = dict(strict_items=True)
    got = first_error(iter_batches(TableData(cols, N_ROWS), data["pt_fm"], 64,
                                   item_store=data["pt_store"], **kw))
    want = first_error(jax_iter_batches(JaxTableData(cols, N_ROWS), data["jax_fm"], 64,
                                        item_store=data["jax_store"], **kw))
    assert got == want and "[7]" in got
    tolerant = list(iter_batches(TableData(cols, N_ROWS), data["pt_fm"], 64,
                                 item_store=data["pt_store"]))
    assert not tolerant[2]["item_emb_d128"][130 - 128].any()


# ---------------------------------------------------------- stream_batches
@pytest.mark.parametrize("shuffle, epoch, host_index, host_count, drop_last, join, label", [
    (False, 0, 0, 1, False, False, True),
    (True, 0, 0, 1, False, True, True),
    (True, 1, 0, 2, False, False, True),
    (True, 1, 1, 2, True, False, True),
    (False, 0, 1, 2, False, True, False),
    (True, 0, 0, 2, True, True, True),
])
def test_stream_batches_match_jax(data, shuffle, epoch, host_index, host_count, drop_last,
                                  join, label):
    kw = dict(shuffle=shuffle, seed=9, epoch=epoch, shuffle_buffer=2, host_index=host_index,
              host_count=host_count, drop_last=drop_last, include_label=label)
    got = streaming.stream_batches(data["path"], data["pt_fm"], 64,
                                   item_store=data["pt_store"] if join else None, **kw)
    want = jax_streaming.stream_batches(data["path"], data["jax_fm"], 64,
                                        item_store=data["jax_store"] if join else None, **kw)
    assert_same_batches(got, want)


def test_stream_strict_join_raises_as_jax(data, tmp_path):
    cols = pq.read_table(data["path"])
    item = cols.column("item_id").to_numpy().copy()
    item[300] = 7
    path = str(tmp_path / "strict.parquet")
    pq.write_table(cols.set_column(cols.schema.get_field_index("item_id"), "item_id",
                                   pa.array(item)), path, row_group_size=ROW_GROUP)
    for fn, fm, store in ((streaming.stream_batches, data["pt_fm"], data["pt_store"]),
                          (jax_streaming.stream_batches, data["jax_fm"], data["jax_store"])):
        with pytest.raises(KeyError, match=r"\[7\]"):
            list(fn(path, fm, 64, item_store=store, strict_items=True))


@pytest.mark.parametrize("batch_size, hosts", [(64, 1), (64, 2), (50, 3), (1000, 1)])
def test_common_step_count_matches_jax(data, batch_size, hosts):
    assert (streaming.common_step_count(data["path"], batch_size, hosts)
            == jax_streaming.common_step_count(data["path"], batch_size, hosts))


def test_window_batches_on_numpy_chunks_equal_stream_batches(data):
    """The window alone, fed the split's row groups as numpy column dicts in
    record batches of 4 x 64 rows, in host_row_groups' order: the batches of
    stream_batches (host 1 of 2, shuffled, the item join)."""
    kw = dict(shuffle=True, seed=4, epoch=1, host_index=1, host_count=2)
    groups, rng = streaming.host_row_groups(8, **kw)
    cols = {k: v for k, v in data["cols"].items()}

    def chunks():
        for g in groups:
            lo, hi = g * ROW_GROUP, min((g + 1) * ROW_GROUP, N_ROWS)
            for s in range(lo, hi, 256):
                yield {k: v[s : min(s + 256, hi)] for k, v in cols.items()}

    got = streaming.window_batches(chunks(), data["pt_fm"], 64, rng=rng, shuffle=True,
                                   shuffle_buffer=2, item_store=data["pt_store"])
    want = streaming.stream_batches(data["path"], data["pt_fm"], 64, shuffle_buffer=2,
                                    item_store=data["pt_store"], **kw)
    assert_same_batches(got, want)


# ---------------------------------------------------------------- prefetch
def _prefetch_threads():
    return [t for t in threading.enumerate() if t.name == "prefetch"]


def test_prefetch_keeps_order_and_transforms():
    assert list(prefetch(iter(range(50)), transform=lambda x: 2 * x, depth=3)) == [
        2 * x for x in range(50)]
    assert list(prefetch(iter([]))) == []


def test_prefetch_raises_the_workers_exception_in_the_consumer():
    def gen():
        yield 1
        yield 2
        raise ValueError("decode failed")

    got = []
    with pytest.raises(ValueError, match="decode failed"):
        for x in prefetch(gen(), depth=1):
            got.append(x)
    assert got == [1, 2]


def test_closing_prefetch_early_stops_the_worker_and_its_source():
    """The consumer takes 2 items and closes; the worker (blocked on a full
    queue) stops, closes its source generator and exits, and a nested
    prefetch's worker exits with it."""
    closed = threading.Event()

    def gen():
        try:
            for i in range(10_000):
                yield np.full(1000, i)
        finally:
            closed.set()

    it = prefetch(prefetch(gen(), depth=2), transform=lambda a: a + 1, depth=2)
    assert next(it)[0] == 1 and next(it)[0] == 2
    it.close()
    deadline = time.monotonic() + 10
    while _prefetch_threads() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not _prefetch_threads() and closed.is_set()


@pytest.fixture(autouse=True)
def _no_leaked_worker():
    yield
    deadline = time.monotonic() + 10
    while _prefetch_threads() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not _prefetch_threads()

