"""The port's train CLI takes the JAX train CLI's ``--rng-impl``.

The JAX CLI carries the flag into ``train.rng_impl`` and so into the
checkpoint's ``experiment.json``. The port has no counterpart of the TPU's
hardware bit generator and ignores the field, but parses the flag and
records it as JAX does.
"""

import json

import torch

torch.set_num_threads(2)


def test_rng_impl_is_recorded_as_the_jax_cli_records_it(tmp_path):
    from ctr_recommendation_tpu.cli.train import main as jax_train
    from ctr_recommendation_tpu_torch.cli.train import main as port_train

    data = str(tmp_path / "data")
    argv = ["--synthetic", data, "--synthetic-rows", "2000", "--synthetic-items", "200",
            "--epochs", "1", "--embedding-dim", "8", "--batch-size", "256", "--no-pallas",
            "--rng-impl", "rbg"]
    assert jax_train([*argv, "--checkpoint-dir", str(tmp_path / "jax")]) == 0
    assert port_train([*argv, "--checkpoint-dir", str(tmp_path / "port"),
                       "--device", "cpu"]) == 0
    recorded = {side: json.loads((tmp_path / side / "experiment.json").read_text())
                for side in ("jax", "port")}
    assert recorded["jax"]["train"]["rng_impl"] == "rbg"
    assert recorded["port"]["train"]["rng_impl"] == recorded["jax"]["train"]["rng_impl"]
