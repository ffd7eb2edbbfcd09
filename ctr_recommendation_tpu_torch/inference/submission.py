"""Kaggle submission writer.

Format parity with the reference output (Prediction.py:120-126):
``prediction_fibinet.csv`` with columns ``ID`` (0-based row index) and
``Task2`` (click probability), zipped into ``submission_fibinet.zip``.

The CSV's bytes are the JAX package's: each float32 is written as
``std::to_chars`` writes it (the shortest decimal that reads back to the same
float32, in fixed or scientific form, whichever is shorter, fixed on a tie,
with a two-digit exponent), and an integral value gets ``.0`` (``0.0``,
``1.0``: pandas' form). The native writer (``data/native/submission.cc``)
does it on several threads; the Python writer here writes the same bytes
where the native one is unavailable.
"""

from __future__ import annotations

import os
import zipfile

import numpy as np

from ctr_recommendation_tpu_torch.data import native

HEADER = "ID,Task2\n"


def _to_chars(v: np.float32) -> str:
    """One float32 as ``std::to_chars`` writes it, ``.0`` appended when it
    has neither a point nor an exponent."""
    if not np.isfinite(v):
        s = ("-" if np.signbit(v) else "") + ("nan" if np.isnan(v) else "inf")
        return s + ".0"
    sci = np.format_float_scientific(v, unique=True, trim="-", exp_digits=2)
    sign, sci_body = ("-", sci[1:]) if sci.startswith("-") else ("", sci)
    mantissa, exp = sci_body.split("e")
    digits, k = mantissa.replace(".", ""), int(exp)
    if k < 0:
        fixed = "0." + "0" * (-k - 1) + digits
    elif len(digits) <= k + 1:
        # then v is an integer, and the fixed form is its exact value
        # (printf's %.0f), not the shortest digits padded with zeros
        fixed = str(int(abs(float(v))))
    else:
        fixed = digits[: k + 1] + "." + digits[k + 1 :]
    s = fixed if len(fixed) <= len(sci_body) else sci_body
    return sign + (s if "." in s or "e" in s else s + ".0")


def format_rows(probs: np.ndarray, id_offset: int = 0) -> str:
    """``id,prob`` lines for one chunk of float32 probabilities, as the
    native writer writes them.

    numpy's shortest float32 repr has the same digits as ``to_chars``; it
    picks the scientific form by magnitude where ``to_chars`` picks the
    shorter form. The two agree for 1e-3 <= |v| < 1e4 (both fixed; an
    integral value reads ``1.0`` in both) and for 0, so only the values
    outside that range are formatted one by one."""
    probs = np.asarray(probs, dtype=np.float32).ravel()
    values = probs.astype(str).tolist()
    mag = np.abs(probs)
    odd = ~((mag >= np.float32(1e-3)) & (mag < np.float32(1e4))) & (mag != 0)
    for i in np.flatnonzero(odd).tolist():
        values[i] = _to_chars(probs[i])
    return "".join(f"{i},{v}\n" for i, v in enumerate(values, id_offset))


def write_csv_python(probs: np.ndarray, csv_path: str, *, id_offset: int = 0,
                     append: bool = False) -> None:
    """The Python writer: the native writer's bytes, the header first on a
    fresh file."""
    with open(csv_path, "a" if append else "w", newline="") as f:
        if not append:
            f.write(HEADER)
        f.write(format_rows(probs, id_offset))


def write_csv_chunk(
    probs: np.ndarray, csv_path: str, *, id_offset: int, append: bool
) -> None:
    """Append one chunk of rows; a fresh file starts with the header. The
    native writer first; a failed native append may have written part of its
    rows, so the file is cut back to its size before the call and the chunk
    is written again by the Python writer, never twice."""
    probs = np.asarray(probs, dtype=np.float32).ravel()
    pre_size = os.path.getsize(csv_path) if append and os.path.exists(csv_path) else 0
    if native.write_csv(probs, csv_path, id_offset=id_offset, append=append):
        return
    if append and os.path.exists(csv_path):
        os.truncate(csv_path, pre_size)
    write_csv_python(probs, csv_path, id_offset=id_offset, append=append)


def zip_submission(csv_path: str, zip_path: str, csv_name: str) -> None:
    if native.zip_file(csv_path, zip_path, csv_name, level=1):
        return
    # compresslevel 1: several times faster than the default for ~10% more bytes
    with zipfile.ZipFile(zip_path, "w", zipfile.ZIP_DEFLATED, compresslevel=1) as z:
        z.write(csv_path, arcname=csv_name)


def write_submission(
    probs: np.ndarray,
    out_dir: str,
    csv_name: str = "prediction_fibinet.csv",
    zip_name: str = "submission_fibinet.zip",
) -> tuple[str, str]:
    """A whole split's probabilities -> the CSV + zip in ``out_dir``."""
    os.makedirs(out_dir, exist_ok=True)
    csv_path = os.path.join(out_dir, csv_name)
    zip_path = os.path.join(out_dir, zip_name)
    write_csv_chunk(probs, csv_path, id_offset=0, append=False)
    zip_submission(csv_path, zip_path, csv_name)
    return csv_path, zip_path
