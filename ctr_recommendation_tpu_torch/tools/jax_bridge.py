"""Move the JAX package's parameters into the port.

The JAX package keeps parameters as nested dicts (and lists) of arrays; so
does the port, in the SAME layout: a Linear weight is stored (in, out) on
both sides and applied as ``x @ w``, so nothing is transposed here. The
bridge checks the JAX tree against the tree the port's own ``init`` builds
for the same feature map and model config (every key and shape, including
the SENet ``fc1``/``fc2`` biases, ``bilinear.w`` for "all" or ``w_each`` for
"each", and the BatchNorm ``bn_mean``/``bn_var`` state) and converts every
leaf to a float32 CPU tensor.

``save``/``load`` keep the flat numpy form the port's predict CLI reads
(``--weights``): one ``.npz`` whose keys are tree paths joined by ``/``,
under ``params/`` and ``model_state/``. Making that file from a JAX export
needs JAX; this module does not import it.
"""

from __future__ import annotations

import numpy as np
import torch

from ctr_recommendation_tpu_torch.config.schema import ModelConfig
from ctr_recommendation_tpu_torch.features.feature_map import FeatureMap
from ctr_recommendation_tpu_torch.models.registry import get_model


def flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """{path: leaf} with dict keys and list indices joined by '/'."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _with_paths(fn, tree, prefix: str = ""):
    """Rebuild ``tree``'s structure with ``fn(path, leaf)`` at every leaf."""
    if isinstance(tree, dict):
        return {k: _with_paths(fn, v, f"{prefix}/{k}" if prefix else k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_with_paths(fn, v, f"{prefix}/{i}" if prefix else str(i)) for i, v in enumerate(tree)]
    return fn(prefix, tree)


def unflatten(flat: dict[str, np.ndarray]):
    """Inverse of ``flatten``: all-digit key levels become lists."""
    root: dict = {}
    for path, v in flat.items():
        node = root
        *parents, last = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = v

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(root)


def _convert(name: str, source, expected):
    flat_src = {k: np.asarray(v) for k, v in flatten(source).items()}
    flat_exp = flatten(expected)
    missing = sorted(set(flat_exp) - set(flat_src))
    extra = sorted(set(flat_src) - set(flat_exp))
    if missing or extra:
        raise ValueError(f"{name} tree mismatch: missing {missing}, unexpected {extra}")
    for k, want in flat_exp.items():
        if tuple(flat_src[k].shape) != tuple(want.shape):
            raise ValueError(
                f"{name}/{k} has shape {flat_src[k].shape}, expected {tuple(want.shape)}"
            )
    return _with_paths(
        lambda path, _: torch.from_numpy(np.array(flat_src[path], dtype=np.float32)),
        expected,
    )


def params_from_jax(
    params_np: dict, model_state_np: dict, fm: FeatureMap, cfg: ModelConfig
) -> tuple[dict, dict]:
    """JAX (params, model_state) as nested dicts of numpy arrays -> the
    port's (params, state), float32 CPU tensors in the same layout."""
    want_params, want_state = get_model(cfg.model).init(torch.Generator(), fm, cfg)
    return (
        _convert("params", params_np, want_params),
        _convert("model_state", model_state_np, want_state),
    )


def save(path: str, params, model_state) -> None:
    """Write (params, model_state) — numpy arrays or tensors — to one .npz."""
    def arr(v):
        return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)

    flat = {f"params/{k}": arr(v) for k, v in flatten(params).items()}
    flat.update({f"model_state/{k}": arr(v) for k, v in flatten(model_state).items()})
    np.savez(path, **flat)


def load(path: str) -> tuple[dict, dict]:
    """(params, model_state) as nested dicts of numpy arrays."""
    with np.load(path) as z:
        tree = unflatten({k: z[k] for k in z.files})
    return tree["params"], tree.get("model_state", {})
