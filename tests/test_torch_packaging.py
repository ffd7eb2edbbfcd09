"""The port's native sources ship with the package.

Every ``.cc``, ``.cu`` and ``.cuh`` file under ``ctr_recommendation_tpu_torch/``
is built at first use from the installed package, so each must match a glob
of ``pyproject.toml``'s ``[tool.setuptools.package-data]``. A source missing
there leaves an installed port without it: the native submission writer
falls back to the Python writer, a kernel fails to build.
"""

import tomllib
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "ctr_recommendation_tpu_torch"


def _shipped() -> set[Path]:
    """The files setuptools' package-data globs select, as it globs them:
    each pattern relative to its package's directory."""
    table = tomllib.loads((REPO / "pyproject.toml").read_text())
    package_data = table["tool"]["setuptools"]["package-data"]
    shipped = set()
    for package, patterns in package_data.items():
        root = REPO.joinpath(*package.split("."))
        for pattern in patterns:
            shipped.update(p.resolve() for p in root.glob(pattern) if p.is_file())
    return shipped


def test_every_native_source_of_the_port_is_package_data():
    sources = {p.resolve() for suffix in ("*.cc", "*.cu", "*.cuh") for p in PORT.rglob(suffix)
               if "_build" not in p.parts}
    assert PORT / "data" / "native" / "submission.cc" in sources
    assert PORT / "csrc" / "scoring.cu" in sources
    missing = sorted(str(p.relative_to(REPO)) for p in sources - _shipped())
    assert not missing, f"not in pyproject.toml's package-data: {missing}"
