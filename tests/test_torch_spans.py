"""The port's stage spans (utils/profiling.py) on the CPU, for MM-FiBiNET and
SASRec-FiBiNET: off, a span is one shared no-op and a stage boundary its
tensor, and nothing is recorded; under ``torch.profiler`` one
``train_step`` emits each stage once as a user annotation, nested as the
step runs them, with the kernel families inside their stages, and
``score_table`` its upload, a span a batch and its download; a traced step
equals an untraced one bit for bit; the stage totals lie inside the step
and ``uploaded_bytes`` counts the columns sent."""

import dataclasses
import math

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ctr_recommendation_tpu_torch.config import microlens_experiment
from ctr_recommendation_tpu_torch.config.loader import microlens_features
from ctr_recommendation_tpu_torch.config.schema import FeatureType
from ctr_recommendation_tpu_torch.data import synthetic_splits
from ctr_recommendation_tpu_torch.inference.predictor import Predictor
from ctr_recommendation_tpu_torch.tools.jax_bridge import flatten
from ctr_recommendation_tpu_torch.training import Trainer
from ctr_recommendation_tpu_torch.utils import profiling
from ctr_recommendation_tpu_torch.utils.profiling import RECORDER, span, stage_boundary

torch.set_num_threads(2)

MODELS = ["mm_fibinet", "sasrec_fibinet"]
ROWS, BS, SCORE_BS = 128, 32, 24  # the 64 validation rows score as 3 padded batches

# each stage of a train step and its parent, in the order the step opens them
TRAIN_STAGES = [
    ("train.step", None), ("train.join", "train.step"), ("trunk", "train.step"),
    ("interaction", "train.step"), ("tower", "train.step"), ("train.loss", "train.step"),
    ("train.backward", "train.step"), ("tower.bwd", "train.backward"),
    ("interaction.bwd", "train.backward"), ("trunk.bwd", "train.backward"),
    ("train.optimizer", "train.step"),
]
# the kernel families' spans and the stage each lies in
FAMILIES = {"interaction.fwd": "interaction", "table_grad": "trunk.bwd"}
SASREC_FAMILIES = {"encoder.fwd": "trunk", "encoder.bwd": "trunk.bwd"}
NAMES = {n for n, _ in TRAIN_STAGES} | set(FAMILIES) | set(SASREC_FAMILIES) | {
    "interaction.bwd", "score.upload", "score.batch", "score.download", "score_fwd"}


@pytest.fixture(scope="module")
def splits():
    return synthetic_splits(ROWS, 64, num_items=199, max_len=8, mm_dim=24, num_users=100, seed=0)


def _experiment(model, ckpt):
    exp = microlens_experiment(
        data_root="", model=model, embedding_dim=16, hidden_units=(32, 16), batch_size=BS,
        epochs=1, max_len=8, checkpoint_dir=str(ckpt), async_checkpointing=False,
        tensorboard=False)
    return exp.replace(dataset=dataclasses.replace(exp.dataset, features=microlens_features(
        item_vocab=200, cate_vocab=11, max_len=8, mm_dim=24)))


def _trainer(model, ckpt, splits):
    train, _, store = splits
    tr = Trainer(_experiment(model, ckpt), steps_per_epoch=ROWS // BS, item_store=store,
                 device="cpu", log_fn=lambda s: None)
    data = tr._upload(train)
    return tr, {k: v[:BS] for k, v in data.items()}


def _annotations(prof) -> list[tuple[str, int, int]]:
    """(name, start, end) of the program's spans in a profile, in start order."""
    out = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events() if e.name() in NAMES]
    return sorted(out, key=lambda x: (x[1], -x[2]))


def _parents(events) -> list[tuple[str, str | None]]:
    """(name, the name of the innermost span enclosing it) for each span."""
    out, stack = [], []
    for name, a, z in events:
        while stack and stack[-1][2] <= a:
            stack.pop()
        out.append((name, stack[-1][0] if stack else None))
        stack.append((name, a, z))
    return out


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


@pytest.mark.parametrize("model", MODELS)
def test_off_spans_are_one_no_op_and_boundaries_their_tensor(model, splits, tmp_path):
    assert not torch.autograd.profiler._is_profiler_enabled
    assert span("train.step") is span("trunk") is profiling._OFF
    with span("score.upload") as s:
        s.add_bytes(10)
    t = torch.ones(3, requires_grad=True) * 2
    assert stage_boundary(t, "tower.bwd") is t
    assert t._backward_hooks is None
    RECORDER.reset()
    tr, batch = _trainer(model, tmp_path, splits)
    tr.train_step(batch)
    assert RECORDER.records == [] and RECORDER.totals() == {}
    assert tr.spans is RECORDER


@pytest.mark.parametrize("model", MODELS)
def test_a_traced_train_step_emits_each_stage_once_nested(model, splits, tmp_path):
    tr, batch = _trainer(model, tmp_path, splits)
    tr.train_step(batch)  # first calls out of the trace
    RECORDER.reset()
    _, prof = _traced(lambda: tr.train_step(batch))
    got = _parents(_annotations(prof))
    # the stages: each once (the interaction backward's kernel span nests in
    # the stage of its name), in the order the step opens them
    stages = [(n, p) for n, p in got if (n, p) in TRAIN_STAGES]
    assert stages == TRAIN_STAGES
    families = dict(FAMILIES, **(SASREC_FAMILIES if model == "sasrec_fibinet" else {}))
    for name, parent in got:
        if (name, parent) not in TRAIN_STAGES:
            assert parent == families.get(name, name), (name, parent)
    assert {n for n, _ in got} == {n for n, _ in TRAIN_STAGES} | set(families)
    # the recorder holds the same spans, with their parents
    assert [(r.name, r.parent) for r in RECORDER.records] == got
    assert tr.spans.totals()["train.step"]["calls"] == 1


@pytest.mark.parametrize("model", MODELS)
def test_a_traced_score_table_emits_upload_batches_download(model, splits, tmp_path):
    tr, _ = _trainer(model, tmp_path, splits)
    _, valid, store = splits
    pred = Predictor(tr.exp, tr.state.params, tr.state.model_state, item_store=store,
                     device="cpu")
    want = pred.score_table(valid, SCORE_BS)
    RECORDER.reset()
    got_probs, prof = _traced(lambda: pred.score_table(valid, SCORE_BS))
    assert torch.equal(torch.as_tensor(got_probs), torch.as_tensor(want))
    got = _parents(_annotations(prof))
    batches = math.ceil(valid.num_rows / SCORE_BS)
    top = [(n, p) for n, p in got if p is None]
    assert top == [("score.upload", None)] + [("score.batch", None)] * batches + [
        ("score.download", None)]
    inner = [(n, p) for n, p in got if p is not None]
    per_batch = [("trunk", "score.batch")]
    if model == "sasrec_fibinet":
        per_batch.append(("encoder.fwd", "trunk"))
    per_batch.append(("score_fwd", "score.batch"))  # the fused scoring path
    assert inner == per_batch * batches
    assert pred.spans.totals()["score.batch"]["calls"] == batches


@pytest.mark.parametrize("model", MODELS)
def test_a_traced_step_equals_an_untraced_one_bit_for_bit(model, splits, tmp_path):
    plain, batch = _trainer(model, tmp_path / "a", splits)
    traced, _ = _trainer(model, tmp_path / "b", splits)

    def step(tr):
        loss, aux = tr.forward_loss(batch)
        grads = tr.gradients(loss, aux)
        tr.apply_gradients(grads, aux)
        return aux.loss, grads

    want_loss, want_grads = step(plain)
    RECORDER.reset()
    (got_loss, got_grads), _ = _traced(lambda: step(traced))
    assert {"tower.bwd", "interaction.bwd", "trunk.bwd"} <= set(RECORDER.totals())
    assert torch.equal(got_loss, want_loss)
    assert len(got_grads) == len(want_grads)
    for g, w in zip(got_grads, want_grads):
        assert torch.equal(g, w)
    for (k, got), want in zip(flatten(traced.state.params).items(),
                              flatten(plain.state.params).values()):
        assert torch.equal(got, want), k
    for (k, got), want in zip(flatten(traced.state.model_state).items(),
                              flatten(plain.state.model_state).values()):
        assert torch.equal(got, want), k


@pytest.mark.parametrize("model", MODELS)
def test_stage_totals_lie_inside_the_step_and_bytes_are_counted(model, splits, tmp_path):
    tr, batch = _trainer(model, tmp_path, splits)
    tr.train_step(batch)
    RECORDER.reset()
    _traced(lambda: [tr.train_step(batch) for _ in range(2)])
    tot = tr.spans.totals()
    assert tot["train.step"]["calls"] == 2
    stages = ["train.join", "trunk", "trunk.bwd", "interaction", "interaction.bwd", "tower",
              "train.loss", "tower.bwd", "train.optimizer"]
    for s in stages:
        assert tot[s]["calls"] == 2 and tot[s]["device_s"] >= 0.0, s
        assert tot[s]["device_s"] == tot[s]["host_s"], s  # CPU work is synchronous
    unspanned = tot["train.step"]["device_s"] - sum(tot[s]["device_s"] for s in stages)
    assert unspanned >= 0.0
    backward = sum(tot[s]["device_s"] for s in ("tower.bwd", "interaction.bwd", "trunk.bwd"))
    assert backward <= tot["train.backward"]["device_s"]

    _, valid, store = splits
    pred = Predictor(tr.exp, tr.state.params, tr.state.model_state, item_store=store,
                     device="cpu")
    assert pred.uploaded_bytes == 0
    padded = math.ceil(valid.num_rows / SCORE_BS) * SCORE_BS
    unread = {f.name for f in pred.fm.features
              if f.type in (FeatureType.PLACEHOLDER, FeatureType.DENSE_EMBEDDING)}
    sent = sum(v.nbytes // v.shape[0] * padded for k, v in valid.columns.items()
               if k not in unread | {pred.fm.label, "__weight__"})
    pred.score_table(valid, SCORE_BS)
    assert pred.uploaded_bytes == sent
    RECORDER.reset()
    _traced(lambda: pred.score_table(valid, SCORE_BS))
    assert pred.uploaded_bytes == 2 * sent
    up = pred.spans.totals()["score.upload"]
    assert (up["calls"], up["bytes"]) == (1, sent)


def test_the_recorder_counts_a_name_once_where_it_nests_in_itself():
    RECORDER.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with span("outer"):
            with span("outer") as inner:
                inner.add_bytes(5)
            with span("leaf"):
                pass
        RECORDER.open("stage", stage=True)  # left open: closed with its enclosing span
    assert [(r.name, r.parent, r.repeat) for r in RECORDER.records[:3]] == [
        ("outer", None, False), ("outer", "outer", True), ("leaf", "outer", False)]
    tot = RECORDER.totals()
    assert tot["outer"]["calls"] == 1 and tot["outer"]["bytes"] == 0
    assert tot["leaf"]["calls"] == 1 and "stage" not in tot  # still open
    RECORDER.close(RECORDER.records[-1])
    assert RECORDER.totals()["stage"]["calls"] == 1
    RECORDER.reset()
    assert RECORDER.totals() == {}
