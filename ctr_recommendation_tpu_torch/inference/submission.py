"""Kaggle submission writer.

Format parity with the reference output (Prediction.py:120-126):
``prediction_fibinet.csv`` with columns ``ID`` (0-based row index) and
``Task2`` (click probability), zipped into ``submission_fibinet.zip``.
Probabilities are written with 9 significant digits, which read back to the
same float32; no pandas and no native toolchain are needed.
"""

from __future__ import annotations

import zipfile

import numpy as np

HEADER = "ID,Task2\n"


def format_rows(probs: np.ndarray, id_offset: int = 0) -> str:
    """``id,prob`` lines for one chunk of float32 probabilities."""
    values = np.asarray(probs, dtype=np.float32).ravel().tolist()
    return "".join(f"{i},{p:.9g}\n" for i, p in enumerate(values, id_offset))


def write_csv_chunk(
    probs: np.ndarray, csv_path: str, *, id_offset: int, append: bool
) -> None:
    """Append one chunk of rows; a fresh file starts with the header."""
    with open(csv_path, "a" if append else "w") as f:
        if not append:
            f.write(HEADER)
        f.write(format_rows(probs, id_offset))


def zip_submission(csv_path: str, zip_path: str, csv_name: str) -> None:
    # compresslevel 1: several times faster than the default for ~10% more bytes
    with zipfile.ZipFile(zip_path, "w", zipfile.ZIP_DEFLATED, compresslevel=1) as z:
        z.write(csv_path, arcname=csv_name)

