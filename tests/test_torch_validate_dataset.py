"""The port's validate_dataset against the JAX package's (CPU).

Every case of tests/test_validate_dataset.py (its fixture writer, the same
mutations) goes through both checkers: the same return code and the same
report lines, ``[ok]``, ``[warn]``, ``[ERROR]`` and the verdict alike.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from ctr_recommendation_tpu.cli import validate_dataset as jax_vd
from ctr_recommendation_tpu.config import serialize as jax_serialize
from ctr_recommendation_tpu_torch.cli import validate_dataset as port_vd
from ctr_recommendation_tpu_torch.config import serialize as pt_serialize
from tests.test_validate_dataset import MM, VOCAB, _experiment, _write_reference_layout

torch.set_num_threads(2)


def _emb_frame(n, ids, dim, seed):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({"item_id": ids,
                         "item_emb_d128": [[float(x) for x in rng.normal(size=dim)]
                                           for _ in range(n)]})


def _mutations(template):
    """name -> (frames to override, expect_rows): the cases of
    tests/test_validate_dataset.py."""
    items = template["item_info"][template["item_info"].item_id != VOCAB - 1]
    oov = template["valid"].copy()
    oov.loc[0, "item_id"] = VOCAB + 50
    unk_train = template["train"].copy()
    unk_train.loc[0, "item_id"] = VOCAB - 1
    unk_test = template["test"].copy()
    unk_test.loc[0, "item_id"] = VOCAB - 1
    bad_labels = template["train"].copy()
    bad_labels["label"] = np.linspace(-1, 2, len(bad_labels))
    soft = template["valid"].copy()
    soft["label"] = np.linspace(0.1, 0.9, len(soft))
    return {
        "reference-layout": ({}, None),
        "expect-rows-met": ({}, {"test": 80}),
        "expect-rows-missed": ({}, {"test": 385024}),
        "missing-file": ({}, None),
        "wrong-emb-length": (
            {"item_info": _emb_frame(VOCAB - 1, np.arange(1, VOCAB, dtype=np.int64), MM - 1, 1)},
            None),
        "non-list-emb": ({"item_info": pd.DataFrame({
            "item_id": np.arange(1, VOCAB, dtype=np.int64),
            "item_emb_d128": np.zeros(VOCAB - 1)})}, None),
        "duplicate-ids": ({"item_info": _emb_frame(10, np.ones(10, np.int64), MM, 2)}, None),
        "missing-model-column": ({"train": template["train"].drop(columns=["likes_level"])},
                                 None),
        "out-of-vocab": ({"valid": oov}, None),
        "unknown-train-item": ({"item_info": items, "train": unk_train}, None),
        "unknown-test-item": ({"item_info": items, "test": unk_test}, None),
        "bad-labels": ({"train": bad_labels}, None),
        "soft-labels": ({"valid": soft}, None),
    }


CASES = ["reference-layout", "expect-rows-met", "expect-rows-missed", "missing-file",
         "wrong-emb-length", "non-list-emb", "duplicate-ids", "missing-model-column",
         "out-of-vocab", "unknown-train-item", "unknown-test-item", "bad-labels", "soft-labels"]
PASSING = {"reference-layout", "expect-rows-met", "unknown-test-item", "soft-labels"}


@pytest.fixture(scope="module")
def template(tmp_path_factory):
    return _write_reference_layout(tmp_path_factory.mktemp("template"))


@pytest.mark.parametrize("case", CASES)
def test_both_checkers_give_the_same_report(case, template, tmp_path):
    frames, expect_rows = _mutations(template)[case]
    root = tmp_path / case
    _write_reference_layout(root, **frames)
    if case == "missing-file":
        (root / "valid.parquet").unlink()
    exp = _experiment(root)
    jax_log, port_log = [], []
    jax_rc = jax_vd.validate(str(root), exp=exp, log=jax_log.append, expect_rows=expect_rows)
    port_rc = port_vd.validate(str(root), exp=pt_serialize.from_json(jax_serialize.to_json(exp)),
                               log=port_log.append, expect_rows=expect_rows)
    assert port_rc == jax_rc
    assert port_log == jax_log
    assert port_rc == (0 if case in PASSING else 1), "\n".join(port_log)


@pytest.mark.parametrize("expect", ["test=80", "test=81"])
def test_both_clis_print_the_same(expect, tmp_path, capsys):
    """main() on the full MicroLens contract (128-d vectors, vocab 91718)."""
    root = tmp_path / "cli"
    _write_reference_layout(root, mm=128)
    argv = ["--data-root", str(root), "--expect-rows", expect]
    jax_rc = jax_vd.main(argv)
    jax_out = capsys.readouterr().out
    port_rc = port_vd.main(argv)
    assert port_rc == jax_rc == (0 if expect == "test=80" else 1)
    assert capsys.readouterr().out == jax_out
