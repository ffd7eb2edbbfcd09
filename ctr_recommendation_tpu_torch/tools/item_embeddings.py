"""Offline multimodal item-embedding generation ("Task 1").

The reference notebook's pipeline: per item, assemble a text string from
title/tags/levels (``"{title} | tags: a, b | likes_level: x | views_level:
y"``), encode it to a high-dim vector, PCA-project to 128 dims, L2-normalize,
and write the ``item_emb_d128`` column back to the item_info parquet, with
zeros for items that have no title and no tags.

Encoders are pluggable:

* :class:`ViltEncoder`: the reference's ``dandelin/vilt-b32-mlm`` CLS-token
  encoder, used when the transformers weights are available locally; the
  model and each processed batch live on ``device``.
* :class:`HashTextEncoder`: a deterministic, dependency-free feature-hashing
  text encoder producing the same 768-d, L2-normalized contract; host work,
  its output equal to the JAX package's bit for bit.

``pca_project`` runs in float64 torch on ``device`` (the card by default):
centre, the eigendecomposition of the d x d covariance, sklearn's
``svd_flip`` sign rule, truncation, L2 renormalization.

``pyarrow`` and ``PIL`` are imported only where a parquet is read or an
image decoded.
"""

from __future__ import annotations

import glob as glob_mod
import hashlib
import os
import re
from typing import Iterable, Protocol, Sequence

import numpy as np
import torch

from ctr_recommendation_tpu_torch.utils.device import resolve_device


# -------------------------------------------------------------------- images
IMAGE_EXTENSIONS = ("jpg", "png", "jpeg", "webp")


def find_image_path(images_dir: str, item_id) -> str | None:
    """Resolve an item's raw image file: probe the common extensions in
    order, then fall back to a glob; None when nothing matches."""
    for ext in IMAGE_EXTENSIONS:
        p = os.path.join(images_dir, f"{item_id}.{ext}")
        if os.path.exists(p):
            return p
    cand = glob_mod.glob(os.path.join(images_dir, f"{item_id}.*"))
    return cand[0] if cand else None


def load_image(path: str | None):
    """PIL RGB image; a black 224x224 placeholder for missing/unreadable
    files."""
    from PIL import Image

    if path is not None:
        try:
            return Image.open(path).convert("RGB")
        except OSError:
            pass
    return Image.fromarray(np.zeros((224, 224, 3), dtype=np.uint8)).convert("RGB")


# --------------------------------------------------------------------- text
def parse_tags(value) -> list[str]:
    """Robust tag parsing: list / ndarray / stringified list / '|' or ','
    separated."""
    if value is None:
        return []
    if isinstance(value, np.ndarray):
        value = value.tolist()
    if isinstance(value, (list, tuple)):
        return [str(t).strip() for t in value if str(t).strip()]
    s = str(value).strip()
    if not s or s.lower() in ("nan", "none"):
        return []
    if s.startswith("[") and s.endswith("]"):
        inner = s[1:-1]
        parts = re.split(r"[,]", inner)
        return [p.strip().strip("'\"") for p in parts if p.strip().strip("'\"")]
    if "|" in s:
        return [p.strip() for p in s.split("|") if p.strip()]
    if "," in s:
        return [p.strip() for p in s.split(",") if p.strip()]
    return [s]


def build_text(title, tags, likes_level, views_level) -> str:
    """'{title} | tags: a, b | likes_level: x | views_level: y'."""
    title = "" if title is None else str(title).strip()
    tag_list = parse_tags(tags)
    parts = [title]
    if tag_list:
        parts.append("tags: " + ", ".join(tag_list))
    parts.append(f"likes_level: {likes_level}")
    parts.append(f"views_level: {views_level}")
    return " | ".join(p for p in parts if p)


# ----------------------------------------------------------------- encoders
class Encoder(Protocol):
    dim: int

    def encode(self, texts: Sequence[str], images=None) -> np.ndarray: ...


class HashTextEncoder:
    """Deterministic feature-hashing bag-of-ngrams encoder -> L2-normed
    ``dim``-d vectors. No model weights needed; stable across runs."""

    def __init__(self, dim: int = 768, ngrams: tuple[int, ...] = (1, 2)):
        self.dim = dim
        self.ngrams = ngrams

    def _tokens(self, text: str) -> Iterable[str]:
        words = re.findall(r"\w+", text.lower())
        for n in self.ngrams:
            for i in range(len(words) - n + 1):
                yield " ".join(words[i : i + n])

    def encode(self, texts: Sequence[str], images=None) -> np.ndarray:
        out = np.zeros((len(texts), self.dim), dtype=np.float32)
        for r, text in enumerate(texts):
            for tok in self._tokens(text):
                h = hashlib.blake2b(tok.encode(), digest_size=8).digest()
                v = int.from_bytes(h, "little")
                idx = v % self.dim
                sign = 1.0 if (v >> 32) & 1 else -1.0
                out[r, idx] += sign
            if images is not None and images[r] is not None:
                # deterministic image signature: hashed coarse color
                # histogram, so the multimodal plumbing changes the output
                # the way a real joint encoder would
                arr = np.asarray(images[r].convert("RGB").resize((16, 16)))
                hist = arr.reshape(-1, 3).mean(axis=0).astype(np.int64) // 16
                h = hashlib.blake2b(hist.tobytes(), digest_size=8).digest()
                v = int.from_bytes(h, "little")
                out[r, v % self.dim] += 2.0 if (v >> 32) & 1 else -2.0
        norms = np.linalg.norm(out, axis=1, keepdims=True)
        return out / np.maximum(norms, 1e-8)


class ViltEncoder:
    """The reference's ViLT CLS encoder.

    By default loads pretrained ``dandelin/vilt-b32-mlm`` weights (they must
    be available locally). ``processor`` / ``model`` may be injected
    instead (e.g. a random-init ``ViltModel(ViltConfig(...))``), which runs
    the same processor->model->CLS->normalize path without weights. The
    model is moved to ``device`` and each processed batch with it."""

    def __init__(
        self,
        model_name: str = "dandelin/vilt-b32-mlm",
        batch_size: int = 16,
        *,
        processor=None,
        model=None,
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        if processor is None or model is None:
            from transformers import ViltModel, ViltProcessor  # noqa: deferred

            processor = processor or ViltProcessor.from_pretrained(model_name)
            model = model or ViltModel.from_pretrained(model_name)
        self.processor = processor
        self.model = model.eval().to(self.device)
        self.batch_size = batch_size
        self.dim = self.model.config.hidden_size

    def encode(self, texts: Sequence[str], images=None) -> np.ndarray:
        from PIL import Image

        outs = []
        for i in range(0, len(texts), self.batch_size):
            chunk = list(texts[i : i + self.batch_size])
            imgs = (
                [im if im is not None else Image.new("RGB", (224, 224)) for im in
                 images[i : i + self.batch_size]]
                if images is not None
                else [Image.new("RGB", (224, 224))] * len(chunk)
            )
            enc = self.processor(
                images=imgs, text=chunk, return_tensors="pt",
                padding=True, truncation=True,
            )
            enc = {k: v.to(self.device) for k, v in enc.items()}
            with torch.no_grad():
                h = self.model(**enc).last_hidden_state[:, 0, :]
            h = torch.nn.functional.normalize(h, dim=-1)
            outs.append(h.cpu().numpy())
        return np.concatenate(outs, axis=0)


# ---------------------------------------------------------------------- PCA
def pca_project(
    x: np.ndarray, n_components: int = 128, device: str | torch.device = "cuda"
) -> np.ndarray:
    """Centre, project onto the leading principal axes with sklearn's
    deterministic sign convention, then L2-renormalize; float32 (N, k), k =
    min(n_components, N, d).

    Computed in float64 on ``device``: the principal axes are the
    eigenvectors of the d x d covariance XcᵀXc (``torch.linalg.eigh``), the
    projection Xc V equals the SVD's U S column for column, and each column
    is signed so that its entry of largest magnitude is positive, which is
    ``svd_flip``'s rule on U."""
    dev = resolve_device(device)
    xc = torch.as_tensor(np.asarray(x), dtype=torch.float64).to(dev)
    xc = xc - xc.mean(dim=0, keepdim=True)
    k = min(n_components, *xc.shape)
    _, vecs = torch.linalg.eigh(xc.T @ xc)  # ascending eigenvalues
    proj = xc @ vecs[:, -k:].flip(1)
    pivot = proj.abs().argmax(dim=0)
    proj = proj * torch.sign(proj[pivot, torch.arange(k, device=dev)])
    proj = proj / proj.norm(dim=1, keepdim=True).clamp(min=1e-8)
    return proj.to(torch.float32).cpu().numpy()


# ----------------------------------------------------------------- pipeline
class _LazyImages:
    """Sequence view over item images that decodes on access (int or slice),
    so the encoder's batches never hold more than one batch of decoded
    bitmaps: eager decoding of ~91K images is multi-GB of RSS."""

    def __init__(self, image_dir: str, item_ids):
        self._dir = image_dir
        self._ids = list(item_ids)

    def __len__(self) -> int:
        return len(self._ids)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        return load_image(find_image_path(self._dir, self._ids[i]))


def generate_item_embeddings(
    item_feature_path: str,
    output_path: str,
    *,
    encoder: Encoder | None = None,
    n_components: int = 128,
    title_col: str = "item_title",
    tags_col: str = "item_tags",
    id_col: str = "item_id",
    image_dir: str | None = None,
    device: str | torch.device = "cuda",
) -> int:
    """item_feature parquet -> item_info parquet with refreshed
    ``item_emb_d128`` (list of n_components floats, L2-normed; zeros for
    items with no title and no tags). Returns the number of items written.

    ``image_dir``: directory of raw item images named ``{item_id}.{ext}``;
    each item's image is resolved by extension probe + glob, loaded as RGB
    with a black 224x224 placeholder for missing files, and fed to the
    encoder jointly with the text. The PCA runs on ``device``."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    table = pq.read_table(item_feature_path)
    cols = {name: table.column(name).to_pylist() for name in table.schema.names}
    n = table.num_rows
    titles = cols.get(title_col, [""] * n)
    tags = cols.get(tags_col, [None] * n)
    likes = cols.get("likes_level", [0] * n)
    views = cols.get("views_level", [0] * n)

    texts = [build_text(t, g, l, v) for t, g, l, v in zip(titles, tags, likes, views)]
    # "empty" = no real content (no title, no tags): build_text always
    # appends the level suffixes, so the assembled text itself is never
    # blank; the zeros contract keys on the content fields
    empty = np.array(
        [
            (t is None or not str(t).strip()) and not parse_tags(g)
            for t, g in zip(titles, tags)
        ]
    )
    images = None
    if image_dir is not None:
        item_ids = cols.get(id_col, list(range(n)))
        # lazy: images decode per encoder batch, not all ~91K at once
        images = _LazyImages(image_dir, item_ids)
    encoder = encoder or HashTextEncoder()
    raw = encoder.encode(texts, images) if images is not None else encoder.encode(texts)
    k = min(n_components, *raw.shape)
    emb = pca_project(raw, k, device=device)
    if k < n_components:  # tiny inputs: zero-pad to the contract width
        emb = np.pad(emb, ((0, 0), (0, n_components - k)))
    emb[empty] = 0.0

    out_cols = {name: table.column(name) for name in table.schema.names
                if name != "item_emb_d128"}
    out_cols["item_emb_d128"] = pa.array([list(map(float, row)) for row in emb])
    pq.write_table(pa.table(out_cols), output_path)
    return n
