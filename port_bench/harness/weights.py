"""The cells' weights, made on the device from the seed in two draws (one
normal, one uniform), in the port's parameter layout (nested dicts and
lists, a Linear's weight stored (in, out) and applied as ``x @ w``), with
the port's initial distributions: tables N(0, 1) (the item table's pad row
0 zero, rows padded to a multiple of 128), Linear layers U(+-1/sqrt(fan_in)),
the bilinear W xavier normal, positional embeddings 0.02 N(0, 1),
LayerNorm and BatchNorm scales 1 and shifts 0, BatchNorm running stats
(0, 1).

``served=True`` gives a trained model's look instead: LayerNorm and
BatchNorm affine parameters and BatchNorm running statistics away from
their initial values, so that folding BatchNorm and the LayerNorms' affine
part do real work.
"""

from __future__ import annotations

import math

import torch

from harness.yardstick import rounded_rows


def flatten(tree, prefix: str = "") -> dict:
    """{path: leaf}, dict keys and list indices joined by '/'."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _linear(fan_in: int, fan_out: int) -> dict:
    bound = 1.0 / math.sqrt(fan_in)
    return {"w": ("uniform", (fan_in, fan_out), bound), "b": ("uniform", (fan_out,), bound)}


def _layout(sizes: dict) -> tuple[dict, dict]:
    """(params, state) trees of leaf specs: (init, shape, scale)."""
    e, f = sizes["embedding_dim"], sizes["fields"]
    r = max(1, f // sizes["senet_reduction"])
    h1, h2 = sizes["hidden_units"]
    cdim = (f + f * (f - 1) // 2) * e
    trunk = {
        "tables": {
            "likes_level": ("normal", (rounded_rows(sizes["cate_vocab"]), e), 1.0),
            "item_id": ("normal", (rounded_rows(sizes["item_vocab"]), e), 1.0),
        },
        "dense": {"item_emb_d128": {"proj": _linear(sizes["mm_dim"], e),
                                    "ln_scale": ("ones", (e,), 0.0),
                                    "ln_bias": ("zeros", (e,), 0.0)}},
    }
    if sizes["seq_pooling"] == "attention":
        blocks = []
        for _ in range(sizes["attn_num_layers"]):
            blocks.append({
                "qkv": _linear(e, 3 * e), "proj": _linear(e, e),
                "ln1_scale": ("ones", (e,), 0.0), "ln1_bias": ("zeros", (e,), 0.0),
                "ffn1": _linear(e, 4 * e), "ffn2": _linear(4 * e, e),
                "ln2_scale": ("ones", (e,), 0.0), "ln2_bias": ("zeros", (e,), 0.0),
            })
        trunk["attn"] = {"item_seq": {"pos_emb": ("normal", (sizes["max_len"], e), 0.02),
                                      "blocks": blocks, "pool_q": _linear(e, e)}}
    layers, states = [], []
    for d_in, d_out in ((cdim, h1), (h1, h2)):
        layers.append({"linear": _linear(d_in, d_out), "bn_scale": ("ones", (d_out,), 0.0),
                       "bn_bias": ("zeros", (d_out,), 0.0)})
        states.append({"bn_mean": ("zeros", (d_out,), 0.0), "bn_var": ("ones", (d_out,), 0.0)})
    params = {
        "trunk": trunk,
        "senet": {"fc1": _linear(f, r), "fc2": _linear(r, f)},
        "bilinear": {"w": ("normal", (e, e), math.sqrt(2.0 / (2 * e)))},
        "mlp": {"layers": layers, "out": _linear(h2, 1)},
    }
    return params, {"mlp": {"layers": states}}


def _build(spec_tree, draw):
    if isinstance(spec_tree, dict):
        return {k: _build(v, draw) for k, v in spec_tree.items()}
    if isinstance(spec_tree, list):
        return [_build(v, draw) for v in spec_tree]
    return draw(*spec_tree)


def make(sizes: dict, gen: torch.Generator, device, *, served: bool = False) -> tuple[dict, dict]:
    """(params, state) of the configuration ``sizes``, fp32 on ``device``."""
    p_spec, s_spec = _layout(sizes)
    specs = list(flatten(p_spec).values()) + list(flatten(s_spec).values())
    count = {"normal": 0, "uniform": 0, "ones": 0, "zeros": 0}
    for init, shape, _ in specs:
        count[init] += math.prod(shape)
    normal = torch.randn((count["normal"],), generator=gen, device=device)
    uniform = torch.rand((count["uniform"],), generator=gen, device=device) * 2.0 - 1.0
    # the served look: one normal draw for every affine and running-stat leaf
    jitter = torch.randn((count["ones"] + count["zeros"],), generator=gen, device=device)
    at = {"normal": 0, "uniform": 0, "jitter": 0}

    def take(pool: str, src: torch.Tensor, shape) -> torch.Tensor:
        n = math.prod(shape)
        out = src[at[pool]: at[pool] + n].reshape(shape).clone()
        at[pool] += n
        return out

    def draw(init, shape, scale):
        if init == "normal":
            return take("normal", normal, shape) * scale
        if init == "uniform":
            return take("uniform", uniform, shape) * scale
        base = torch.ones(shape, device=device) if init == "ones" else torch.zeros(
            shape, device=device)
        if served:
            j = take("jitter", jitter, shape)
            # scales and variances stay positive: 1 + 0.1 N, clamped at 0.5
            return (base + 0.1 * j).clamp(min=0.5) if init == "ones" else base + 0.1 * j
        return base

    params = _build(p_spec, draw)
    state = _build(s_spec, draw)
    params["trunk"]["tables"]["item_id"][0] = 0.0  # the pad row
    return params, state
