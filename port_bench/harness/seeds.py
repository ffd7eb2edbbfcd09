"""Sub-seeds of a run's ``--seed``: one 63-bit integer per purpose, so that
the inputs, the weights and the draws of a run are functions of its seed
alone (any whole number, 64-bit and larger included)."""

from __future__ import annotations

import hashlib


def sub_seed(seed: int, purpose: str) -> int:
    digest = hashlib.sha256(f"{int(seed)}/{purpose}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)
