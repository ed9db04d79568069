"""Dataset location (counterpart of ``fetode_tpu/data/paths.py``).

Nothing is vendored: loaders look under ``$FETODE_DATA_DIR`` and then the
repo's ``datasets/`` directory, and the synthetic generators stand in
when the files are absent.
"""

from __future__ import annotations

import os

_DATA_ROOTS = (
    os.environ.get("FETODE_DATA_DIR", ""),
    os.path.join(os.path.dirname(__file__), "..", "..", "datasets"),
)


def locate(relpath: str) -> str | None:
    """The first existing path for ``relpath`` under the data roots."""
    for root in _DATA_ROOTS:
        if root and os.path.exists(os.path.join(root, relpath)):
            return os.path.join(root, relpath)
    return None
