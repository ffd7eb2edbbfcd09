"""The yardstick's operation and byte counts against the figures of the
port's own kernel timings (chip_smoke.py's [time] lines on an H100, PR 27's
log), and its table-gradient shapes against chip_smoke.py's."""

import pytest

from harness import yardstick as ys

E, F, B_FWD, B_BWD = 128, 6, 8192, 4096


def test_interaction_and_scoring_counts():
    assert ys.interaction_fwd(B_FWD, F, E) == (100_696_244, 1_342_177_280)
    assert ys.interaction_fwd(B_FWD, F, E, "each") == (100_827_316, 1_342_177_280)
    assert ys.fused_score(B_FWD, F, E, 512, 256) == (15_666_872, 26_042_433_536)
    assert ys.fused_score(B_FWD, F, E, 512, 256, "each")[0] == 15_797_944
    assert ys.interaction_bwd(B_BWD, F, E) == (56_721_768, 2_013_265_920)
    assert ys.interaction_bwd(B_BWD, F, E, "each")[0] == 57_114_984


@pytest.mark.parametrize("s,e,layers,fwd,bwd", [
    (20, 128, 1, (84_941_312, 64_424_509_440, 1_677_721_600),
     (64_435_200, 96_636_764_160, 2_516_582_400)),
    (20, 256, 1, (170_013_696, 257_698_037_760, 3_355_443_200),
     (130_902_016, 386_547_056_640, 5_033_164_800)),
])
def test_encoder_counts(s, e, layers, fwd, bwd):
    assert ys.encoder_fwd(B_FWD, s, e, layers) == fwd
    assert ys.encoder_bwd(B_BWD, s, e, layers) == bwd


def test_table_grad_bytes():
    assert ys.table_grad(8192, 129, 128) == 4_325_888  # likes_level
    assert ys.table_grad(86_016, 91_777, 128) == 91_718_144  # the item table


def test_bound_matches_the_logged_bounds():
    nbytes, ops = ys.interaction_fwd(B_FWD, F, E)
    assert ys.bound(nbytes, ops)["bound_ms"] == pytest.approx(0.030058580298507463, rel=1e-12)
    assert ys.bound(nbytes, ops)["bound_by"] == "bytes"
    nbytes, ops = ys.fused_score(B_FWD, F, E, 512, 256)
    assert ys.bound(nbytes, ops)["bound_ms"] == pytest.approx(0.026332086487360972, rel=1e-12)
    assert ys.bound(4_325_888, 0)["bound_ms"] == pytest.approx(0.0012913098507462686, rel=1e-12)


def test_attention_counts_at_true_widths():
    # the logged ML-1M attention counted at the kernels' padded D = 64
    assert ys.attention_fwd(B_FWD, 200, 64, 1)[1] == 4 * B_FWD * 200 * 200 * 64
    # the bound takes the faster of 3xTF32 and fp32 on the CUDA cores
    nbytes, ops = ys.attention_fwd(B_FWD, 200, 50, 1)
    want = max(nbytes / ys.HBM_BYTES_PER_S, 3 * ops / ys.PEAK_FLOPS["tf32"]) * 1e3
    assert ys.attention_bound_ms(nbytes, ops) == pytest.approx(want)


@pytest.mark.parametrize("config", ["mm_fibinet", "sasrec_fibinet_ml1m"])
def test_tg_step_shapes_match_chip_smoke(config):
    import json
    import os

    import chip_smoke
    from conftest import BENCH
    from harness import program

    cfg = json.load(open(os.path.join(BENCH, "configs", config + ".json")))
    exp = program.experiment(cfg, batch_size=4096)
    assert ys.tg_step_shapes(cfg["sizes"], 4096) == chip_smoke.tg_step_shapes(exp, 4096)


def test_model_flops():
    sizes = {"embedding_dim": 128, "fields": 6, "hidden_units": [512, 256], "senet_reduction": 2,
             "mm_dim": 128, "seq_pooling": "mean"}
    # projection 32,768; SENet 72; bilinear 163,840 + 1,920; tower 3,015,168
    assert ys.model_flops_per_example(sizes) == 32_768 + 72 + 163_840 + 1_920 + 3_015_168
    sas = dict(sizes, embedding_dim=50, seq_pooling="attention", max_len=200, attn_num_layers=2)
    base = ys.model_flops_per_example(dict(sas, seq_pooling="mean"))
    enc = 2 * 200 * (24 * 50 * 50 + 4 * 200 * 50) + 2 * 50 * 50 + 4 * 200 * 50
    assert ys.model_flops_per_example(sas) == base + enc
