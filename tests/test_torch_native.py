"""The port's submission CSV against the JAX package's, byte for byte (CPU).

The JAX package writes the CSV with its native writer
(ctr_recommendation_tpu/data/native/submission.cc: std::to_chars, the
shortest decimal that reads back to the same float32, and ``.0`` after an
integral value). The port's native writer (its own copy of that source) and
its Python writer must write the same bytes for the same float32
probabilities, on every path: a whole write, chunked appends, a failed
native append cut back and redone in Python, write_submission and the
pipeline. Also: the library's build, the zips, and the port's numpy
``pad_from_offsets`` against the JAX package's native sequence padding.
"""

import time
import zipfile

import numpy as np
import pytest
import torch

from ctr_recommendation_tpu.data import native as jax_native
from ctr_recommendation_tpu_torch.data import native
from ctr_recommendation_tpu_torch.inference import submission

torch.set_num_threads(2)

ONE_BELOW_ONE = np.nextafter(np.float32(1), np.float32(0))
CASES = {
    # the values where the former writer ('{:.9g}') differed: 0, 1, 1e-08
    "integral-and-tiny": [0.0, 1.0, 1e-8],
    # either side of to_chars' switch between the fixed and scientific forms
    "fixed-scientific-switch": [1e-4, 1.2e-4, 1.234e-5, 1e-3],
    "float32-below-one": [ONE_BELOW_ONE],
    "random-10000": np.random.default_rng(0).random(10_000),
    # far from probabilities: every exponent of float32, signs, -0, inf
    "wide-range": np.concatenate([
        10.0 ** np.random.default_rng(1).uniform(-45, 38, 2000),
        -np.random.default_rng(2).random(50), [-0.0, 1e5, 1e16, 151815776.0, np.inf]]),
}


@pytest.fixture(scope="module", autouse=True)
def jax_native_writer():
    """The JAX package builds its writer in place, not through a temporary
    file: a test process that loads it while another process's g++ is
    writing it gets no library, and keeps that answer. Ask again once that
    build has had time to finish."""
    for _ in range(60):
        if jax_native.submission_available():
            return
        jax_native._sub_tried = False
        time.sleep(1)
    pytest.fail("the JAX package's native submission writer did not build")


def _jax_bytes(probs, tmp_path) -> bytes:
    path = str(tmp_path / "jax.csv")
    assert jax_native.write_csv(probs, path)
    return open(path, "rb").read()


def _native(probs, path):
    assert native.write_csv(probs, path)


def _python(probs, path):
    submission.write_csv_python(probs, path)


def _chunks(probs, path):
    """The pipeline's writer: chunk appends with IDs from the rows so far."""
    for s in range(0, max(len(probs), 1), 3):
        submission.write_csv_chunk(probs[s : s + 3], path, id_offset=s, append=s > 0)


WRITERS = {"native": _native, "python": _python, "chunks": _chunks}


@pytest.mark.parametrize("writer", sorted(WRITERS))
@pytest.mark.parametrize("case", list(CASES))
def test_csv_bytes_match_the_jax_native_writer(case, writer, tmp_path):
    probs = np.asarray(CASES[case], np.float32)
    path = str(tmp_path / "port.csv")
    WRITERS[writer](probs, path)
    assert open(path, "rb").read() == _jax_bytes(probs, tmp_path)


def test_the_former_writers_values_now_read_as_pandas_writes_them(tmp_path):
    path = str(tmp_path / "p.csv")
    submission.write_csv_chunk(np.array([0, 1, 1e-8, 0.5], np.float32), path,
                               id_offset=0, append=False)
    assert open(path).read() == "ID,Task2\n0,0.0\n1,1.0\n2,1e-08\n3,0.5\n"


def test_native_append_continues_ids_without_a_second_header(tmp_path):
    probs = np.random.default_rng(3).random(50).astype(np.float32)
    path = str(tmp_path / "p.csv")
    assert native.write_csv(probs[:20], path)
    assert native.write_csv(probs[20:], path, id_offset=20, append=True)
    lines = open(path).read().splitlines()
    assert lines[0] == "ID,Task2" and lines.count("ID,Task2") == 1
    assert [int(ln.split(",")[0]) for ln in lines[1:]] == list(range(50))
    assert open(path, "rb").read() == _jax_bytes(probs, tmp_path)


def test_a_failed_native_append_is_cut_back_and_written_once(tmp_path, monkeypatch):
    probs = np.random.default_rng(4).random(40).astype(np.float32)
    path = str(tmp_path / "p.csv")
    submission.write_csv_chunk(probs[:25], path, id_offset=0, append=False)

    def partial_then_fail(p, csv_path, *, id_offset, append, n_threads=4):
        with open(csv_path, "a") as f:  # part of the rows, then an error
            f.write(f"{id_offset},0.12")
        return False

    monkeypatch.setattr(native, "write_csv", partial_then_fail)
    submission.write_csv_chunk(probs[25:], path, id_offset=25, append=True)
    assert open(path, "rb").read() == _jax_bytes(probs, tmp_path)


@pytest.mark.parametrize("native_on", [True, False], ids=["native", "fallback"])
def test_write_submission_bytes_and_zip(native_on, tmp_path, monkeypatch):
    probs = np.random.default_rng(5).random(1000).astype(np.float32)
    probs[:3] = [0.0, 1.0, 1e-8]
    if not native_on:
        monkeypatch.setattr(native, "write_csv", lambda *a, **k: False)
        monkeypatch.setattr(native, "zip_file", lambda *a, **k: False)
    csv_path, zip_path = submission.write_submission(probs, str(tmp_path / "out"))
    want = _jax_bytes(probs, tmp_path)
    assert open(csv_path, "rb").read() == want
    with zipfile.ZipFile(zip_path) as z:
        assert z.testzip() is None
        assert z.namelist() == ["prediction_fibinet.csv"]
        assert z.read("prediction_fibinet.csv") == want


def test_empty_submission_is_the_header(tmp_path):
    csv_path, _ = submission.write_submission(np.zeros(0, np.float32), str(tmp_path))
    assert open(csv_path, "rb").read() == _jax_bytes(np.zeros(0, np.float32), tmp_path)
    assert open(csv_path).read() == "ID,Task2\n"


def test_pipeline_csv_is_the_jax_writers_bytes(tmp_path, tiny_experiment, tiny_feature_map):
    """The pipeline's chunk appends (the native writer, IDs from the rows
    written so far) give the JAX writer's bytes for score_table's values."""
    from ctr_recommendation_tpu_torch.data import TableData
    from ctr_recommendation_tpu_torch.inference import Predictor, run_submission_pipeline
    from tests.conftest import make_batch
    from tests.test_torch_predictor import _item_store, _setup

    _, _, _, pexp, pparams, pstate = _setup(tiny_experiment, tiny_feature_map, "all", "float32")
    batch = make_batch(np.random.default_rng(6), 200)
    cols = {k: v for k, v in batch.items() if k != "item_emb_d128"}
    pred = Predictor(pexp, pparams, pstate, device="cpu", item_store=_item_store(batch))
    chunks = [{k: v[s : s + 64] for k, v in cols.items()} for s in range(0, 200, 64)]
    n, csv_path, zip_path = run_submission_pipeline(chunks, pred, str(tmp_path), batch_size=32)
    assert n == 200
    want = _jax_bytes(pred.score_table(TableData(cols, 200), batch_size=32), tmp_path)
    assert open(csv_path, "rb").read() == want
    with zipfile.ZipFile(zip_path) as z:
        assert z.read("prediction_fibinet.csv") == want


def test_the_library_is_named_by_a_hash_of_its_source(tmp_path, monkeypatch):
    assert native.submission_available()
    lib = native.build()
    assert lib == native.library_path() and lib.exists()
    assert lib.parent == native.BUILD_DIR and lib.name.startswith("libsubmission-")
    edited = tmp_path / "submission.cc"
    edited.write_bytes(native.SRC.read_bytes() + b"// edited\n")
    monkeypatch.setattr(native, "SRC", edited)
    assert native.library_path() != lib


@pytest.mark.parametrize("lens, max_len", [
    ([0, 1, 3, 8, 12, 0], 8),  # empty rows, shorter, exact, truncated
    ([0, 0, 0], 4),  # every row empty
    ([5, 2, 9], 1),
])
def test_pad_from_offsets_matches_the_jax_native_padding(lens, max_len):
    from ctr_recommendation_tpu_torch.data.parquet import pad_from_offsets

    rng = np.random.default_rng(sum(lens) + max_len)
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    values = rng.integers(1, 1000, offsets[-1]).astype(np.int64)
    want = jax_native.pad_sequences_from_offsets(values, offsets, max_len, pad_id=0)
    got = pad_from_offsets(values, offsets, max_len, 0)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
