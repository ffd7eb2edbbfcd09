"""Time the encoder's attention kernels of two or more checkouts of the
PyTorch port on one card, in one call.

    python3 scripts/encoder_attention_ab.py PARENT_TREE CHANGE_TREE CHANGE_TREE PARENT_TREE

Each argument is the root of a checkout (its kernels are built there on
first use); each runs in its own process, in the order given, so that a
parent / change / change / parent order shows the card's drift. Each run
prints one JSON line: the tree, the card's name and power limit, and the
median ms (CUDA events, 30 runs after 3 warm-ups) of

- the staged ``attention_fwd`` (B = 8192) and ``attention_bwd`` (B = 4096)
  alone, bf16 output, H = 2, at S = 20 for E = 128 and 256, and at S = 32
  and 50 for E = 128 where the tree's kernels take it (else null);
- the same for the streamed pair, ``attention_fwd_streamed`` and
  ``attention_bwd_streamed``, at S = 20, 32, 50 and 200 for E = 128 and at
  S = 20 for E = 256, where the tree has it (``stream_*`` keys; else null);
- the whole encoder, ``encode_fwd`` (B = 8192) and ``encode_bwd`` (B =
  4096), bf16, E = 128, H = 2, L = 1, dropout 0.1, at S = 20, and at S =
  200 where the tree takes it (else null).

The inputs come from seed 0: histories of random pad lengths, the port's
own parameter init. Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

B_FWD, B_BWD, HEADS, REPS = 8192, 4096, 2, 30


def time_ms(torch, fn) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        a, z = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        z.record()
        z.synchronize()
        times.append(a.elapsed_time(z))
    return sorted(times)[REPS // 2]


def operands(torch, b: int, s: int, e: int):
    """(x, amask, weights) of a seeded bf16 history batch, one layer."""
    from ctr_recommendation_tpu_torch.ops import attention
    from ctr_recommendation_tpu_torch.ops.cuda.sasrec_encoder import encoder_inputs, stack_weights
    from ctr_recommendation_tpu_torch.utils.tree import tree_map

    params = tree_map(lambda t: t.cuda(), attention.init(
        torch.Generator().manual_seed(0), e, s, num_heads=HEADS, num_layers=1))
    gen = torch.Generator(device="cuda").manual_seed(0)
    lens = torch.randint(0, s + 1, (b,), generator=gen, device="cuda")
    pos = torch.arange(s, device="cuda")[None, :]
    ids = torch.randint(1, 91718, (b, s), generator=gen, device="cuda")
    ids = torch.where(pos < (s - lens)[:, None], torch.zeros_like(ids), ids)
    seq_emb = torch.randn((b, s, e), generator=gen, device="cuda").to(torch.bfloat16)
    x, amask, _ = encoder_inputs(params, seq_emb, ids)
    return x, amask, stack_weights(params, torch.bfloat16)


def attention_times(torch, s: int, e: int, streamed: bool = False) -> tuple:
    from ctr_recommendation_tpu_torch.ops.cuda import encoder_blocks as eb

    gen = torch.Generator(device="cuda").manual_seed(1)
    _, amask, _ = operands(torch, B_FWD, s, e)
    qkv = torch.randn((B_FWD * s, 3 * e), generator=gen, device="cuda")
    nb = B_BWD * s
    dao = torch.randn((nb, e), generator=gen, device="cuda")
    bf16, qb, ab = torch.bfloat16, qkv[:nb], amask[:B_BWD].contiguous()
    if streamed:
        fwd = time_ms(torch, lambda: eb.attention_fwd_streamed(qkv, amask, HEADS, bf16))
        _, o, stats = eb.attention_fwd_streamed(qb, ab, HEADS, bf16)
        return fwd, time_ms(torch, lambda: eb.attention_bwd_streamed(qb, ab, o, stats, dao, bf16))
    fwd = time_ms(torch, lambda: eb.attention_fwd(qkv, amask, HEADS, bf16))
    _, p = eb.attention_fwd(qb, ab, HEADS, bf16)
    return fwd, time_ms(torch, lambda: eb.attention_bwd(qb, p, dao, bf16))


def worker(label: str) -> None:
    import torch

    from ctr_recommendation_tpu_torch.ops.cuda import encoder_blocks as eb
    from ctr_recommendation_tpu_torch.ops.cuda import sasrec_encoder as enc

    out = {"tree": label, "card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()}
    for s, e in ((20, 128), (20, 256), (32, 128), (50, 128)):
        try:
            enc.check_envelope(s, e, HEADS, 1)
        except ValueError:
            out[f"attn_fwd_S{s}_E{e}"] = out[f"attn_bwd_S{s}_E{e}"] = None
            continue
        out[f"attn_fwd_S{s}_E{e}"], out[f"attn_bwd_S{s}_E{e}"] = attention_times(torch, s, e)
    for s, e in ((20, 128), (32, 128), (50, 128), (200, 128), (20, 256)):
        keys = f"stream_fwd_S{s}_E{e}", f"stream_bwd_S{s}_E{e}"
        times = (attention_times(torch, s, e, streamed=True)
                 if hasattr(eb, "attention_fwd_streamed") else (None, None))
        out.update(zip(keys, times))
    for s in (20, 200):
        if not enc.fits(s, 128, HEADS, 1):
            out[f"encode_fwd_S{s}_E128"] = out[f"encode_bwd_S{s}_E128"] = None
            continue
        x, amask, ws = operands(torch, B_FWD, s, 128)
        seed = torch.tensor([7], dtype=torch.int64, device="cuda")
        kw = dict(num_heads=HEADS, seed=seed, rate=0.1)
        out[f"encode_fwd_S{s}_E128"] = time_ms(torch, lambda: enc.encode_fwd(x, amask, *ws, **kw))
        x, amask = x[:B_BWD].contiguous(), amask[:B_BWD].contiguous()
        g = torch.randn_like(x, dtype=torch.float32).to(torch.bfloat16)
        out[f"encode_bwd_S{s}_E128"] = time_ms(
            torch, lambda: enc.encode_bwd(g, x, amask, *ws, **kw))
        del x, amask, ws, g
    print(json.dumps(out), flush=True)


def main(argv: list[str]) -> int:
    if len(argv) >= 2 and argv[0] == "--worker":
        worker(argv[1])
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    rc = 0
    for tree in argv:
        root = os.path.abspath(tree)
        env = dict(os.environ, PYTHONPATH=root)
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", tree],
                             cwd=root, env=env).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
