"""The port's Task-1 item embeddings (tools/item_embeddings.py,
cli/item_embeddings.py) against the JAX package's, on the CPU, after
tests/test_item_embeddings.py: the text and image helpers equal; the hash
encoder's output equal bit for bit, with and without images; pca_project
at device="cpu" (float64 eigendecomposition of the covariance) within 1e-5
of the JAX one (float32 SVD) on seeded matrices whose kept singular values
do not tie; the parquet pipeline and the CLI writing the JAX pipeline's
columns, with zeros where it has them; ViltEncoder on a random-init,
weights-free transformers stack equal to the JAX ViltEncoder on the same
model object."""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from ctr_recommendation_tpu.tools import item_embeddings as jie
from ctr_recommendation_tpu_torch.cli import item_embeddings as cli
from ctr_recommendation_tpu_torch.tools import item_embeddings as pie

torch.set_num_threads(2)

PCA_TOL = 1e-5


@pytest.mark.parametrize("value", [
    ["a", "b"], np.array(["a", "b"]), "['a', 'b']", "a|b", "a, b", None, "nan", "", "None",
    "single", ("x ", " y"), "[]", "['a', \"b\", '']", "a|b, c",
])
def test_parse_tags_as_jax(value):
    assert pie.parse_tags(value) == jie.parse_tags(value)


@pytest.mark.parametrize("args", [
    ("Cat video", ["cute", "cat"], 3, 7), ("", None, 0, 0), (None, "x|y", 1, 2),
    ("  t  ", "[]", 5, 9), ("abc", np.array(["p", "q"]), 10, 0),
])
def test_build_text_as_jax(args):
    assert pie.build_text(*args) == jie.build_text(*args)


def _write_png(path, color, size=(32, 32)):
    from PIL import Image

    Image.new("RGB", size, color).save(path)


@pytest.fixture
def image_dir(tmp_path):
    d = tmp_path / "imgs"
    d.mkdir()
    _write_png(d / "1.png", (255, 0, 0))
    _write_png(d / "2.webp", (0, 255, 0))
    _write_png(d / "4.jpeg", (0, 0, 255), size=(40, 20))
    (d / "3.bmp").write_bytes(b"")  # only findable through the glob, and unreadable
    (d / "5.jpg").write_bytes(b"not an image")
    return d


@pytest.mark.parametrize("item_id", [1, 2, 3, 4, 5, 99])
def test_find_image_path_and_load_image_as_jax(image_dir, item_id):
    got = pie.find_image_path(str(image_dir), item_id)
    assert got == jie.find_image_path(str(image_dir), item_id)
    a, b = pie.load_image(got), jie.load_image(got)
    assert a.size == b.size and a.mode == b.mode == "RGB"
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


TEXTS = [
    "Cat video | tags: cute, cat | likes_level: 3 | views_level: 7",
    "likes_level: 0 | views_level: 0",
    "same text", "same text", "Ünïcode wörds and_underscores 42 | tags: x",
    "a b c d e f g h i j k l m n o p q r s t u v w x y z " * 3,
]


@pytest.mark.parametrize("dim, with_images", [(768, False), (768, True), (64, False),
                                              (64, True)])
def test_hash_encoder_bit_for_bit(image_dir, dim, with_images):
    images = None
    if with_images:
        images = [pie.load_image(pie.find_image_path(str(image_dir), i))
                  for i in (1, 2, 4, 99, 5, 1)]
        images[3] = None  # an item without an image
    got = pie.HashTextEncoder(dim=dim).encode(TEXTS, images)
    want = jie.HashTextEncoder(dim=dim).encode(TEXTS, images)
    assert got.dtype == want.dtype == np.float32 and got.shape == (len(TEXTS), dim)
    np.testing.assert_array_equal(got, want)


def _decaying(n, d, decay, seed):
    """(n, d) float32 with singular values decaying by ``decay`` a step, in
    random bases: no two kept singular values tie."""
    rng = np.random.default_rng(seed)
    r = min(n, d)
    u, _ = np.linalg.qr(rng.standard_normal((n, r)))
    v, _ = np.linalg.qr(rng.standard_normal((d, r)))
    s = 10.0 * decay ** np.arange(r)
    return ((u * s) @ v.T + rng.standard_normal(d)).astype(np.float32)


@pytest.mark.parametrize("n, d, k, decay", [
    (400, 96, 32, 0.95), (300, 768, 128, 0.99), (64, 32, 128, 0.9), (5, 24, 8, 0.8),
])
def test_pca_project_as_jax(n, d, k, decay):
    x = _decaying(n, d, decay, seed=n + d)
    got = pie.pca_project(x, k, device="cpu")
    want = jie.pca_project(x, k)
    assert got.dtype == np.float32 and got.shape == want.shape == (n, min(k, n, d))
    np.testing.assert_allclose(got, want, rtol=0, atol=PCA_TOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-5)


def test_pca_project_needs_cuda_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pie.pca_project(np.zeros((4, 4), np.float32), 2)


def _item_feature(tmp_path, n=60):
    rng = np.random.default_rng(1)
    table = pa.table({
        "item_id": pa.array(np.arange(n)),
        "item_title": pa.array([f"video about topic {i % 7} and {i % 11}" if i % 9 else ""
                                for i in range(n)]),
        "item_tags": pa.array([["tag%d" % (i % 5), "x%d" % (i % 3)] if i % 9 else []
                               for i in range(n)]),
        "likes_level": pa.array(rng.integers(0, 11, n)),
        "views_level": pa.array(rng.integers(0, 11, n)),
    })
    src = str(tmp_path / "item_feature.parquet")
    pq.write_table(table, src)
    return src


def _emb(path):
    return np.asarray(pq.read_table(path).column("item_emb_d128").to_pylist(), np.float32)


@pytest.mark.parametrize("dims, images", [(128, False), (16, True)])
def test_generate_item_embeddings_as_jax(tmp_path, image_dir, dims, images):
    src = _item_feature(tmp_path)
    kw = {"n_components": dims, "image_dir": str(image_dir) if images else None}
    got_path, want_path = str(tmp_path / "pt.parquet"), str(tmp_path / "jax.parquet")
    assert pie.generate_item_embeddings(src, got_path, device="cpu", **kw) == 60
    assert jie.generate_item_embeddings(src, want_path, **kw) == 60
    got_t, want_t = pq.read_table(got_path), pq.read_table(want_path)
    assert got_t.schema == want_t.schema
    for name in want_t.schema.names:
        if name != "item_emb_d128":
            assert got_t.column(name).equals(want_t.column(name)), name
    got, want = _emb(got_path), _emb(want_path)
    assert got.shape == want.shape == (60, dims)
    np.testing.assert_array_equal(got == 0.0, want == 0.0)
    assert (np.linalg.norm(got, axis=1) == 0.0).sum() == 7  # i % 9 == 0: no title, no tags
    np.testing.assert_allclose(got, want, rtol=0, atol=PCA_TOL)


def test_item_embeddings_cli_hash_as_jax(tmp_path, image_dir, capsys):
    from ctr_recommendation_tpu.cli import item_embeddings as jax_cli

    src = _item_feature(tmp_path, n=30)
    argv = ["--item-feature", src, "--image-dir", str(image_dir), "--encoder", "hash",
            "--dims", "16"]
    assert cli.main([*argv, "--output", str(tmp_path / "pt.parquet"), "--device", "cpu"]) == 0
    assert jax_cli.main([*argv, "--output", str(tmp_path / "jax.parquet")]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out == [f"[out] {tmp_path / 'pt.parquet'}: 30 items, 16-d item_emb_d128",
                   f"[out] {tmp_path / 'jax.parquet'}: 30 items, 16-d item_emb_d128"]
    np.testing.assert_allclose(_emb(tmp_path / "pt.parquet"), _emb(tmp_path / "jax.parquet"),
                               rtol=0, atol=PCA_TOL)


def test_item_embeddings_cli_needs_cuda_unless_told_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src = _item_feature(tmp_path, n=10)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--item-feature", src, "--output", str(tmp_path / "o.parquet"),
                  "--encoder", "hash"])
    assert not (tmp_path / "o.parquet").exists()


def _tiny_vilt(tmp_path):
    """A real transformers ViLT stack, random-init and weights-free, as
    tests/test_item_embeddings.py builds it: (processor, model)."""
    from transformers import (
        BertTokenizerFast,
        ViltConfig,
        ViltImageProcessor,
        ViltModel,
        ViltProcessor,
    )

    vocab = (
        ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
        + list("abcdefghijklmnopqrstuvwxyz0123456789|:,")
        + ["##" + c for c in "abcdefghijklmnopqrstuvwxyz"]
        + ["tags", "likes", "views", "level", "cat", "video"]
    )
    vocab_path = str(tmp_path / "vocab.txt")
    with open(vocab_path, "w") as f:
        f.write("\n".join(vocab))
    tok = BertTokenizerFast(vocab_file=vocab_path, model_max_length=40)
    img_proc = ViltImageProcessor(size={"shortest_edge": 64}, size_divisor=32)
    proc = ViltProcessor(image_processor=img_proc, tokenizer=tok)
    cfg = ViltConfig(
        vocab_size=len(vocab) + 8, hidden_size=32, num_hidden_layers=1,
        num_attention_heads=2, intermediate_size=64, image_size=64,
        patch_size=32, max_position_embeddings=40,
    )
    torch.manual_seed(0)
    return proc, ViltModel(cfg)


@pytest.mark.parametrize("with_images", [False, True])
def test_vilt_encoder_as_jax_on_the_same_model(tmp_path, with_images):
    from PIL import Image

    proc, model = _tiny_vilt(tmp_path)
    texts = [pie.build_text("cat video", ["cute", "cat"], 3, 7), pie.build_text("", None, 0, 0),
             pie.build_text("abc", "x|y", 1, 2)]
    images = ([Image.new("RGB", (224, 224), (255, 0, 0)), None,
               Image.new("RGB", (100, 80), (0, 128, 0))] if with_images else None)
    ours = pie.ViltEncoder(processor=proc, model=model, batch_size=2, device="cpu")
    theirs = jie.ViltEncoder(processor=proc, model=model, batch_size=2)
    assert ours.dim == theirs.dim == 32
    got, want = ours.encode(texts, images), theirs.encode(texts, images)
    assert got.shape == (3, 32)
    np.testing.assert_array_equal(got, want)
