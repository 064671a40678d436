"""Flat ``.npz`` weight files: '/'-joined Flax paths -> nested dict.

A numpy-only copy of ``load_flat_npz`` from the JAX package's checkpoint
module, which the port may not import.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

_SEP = "/"


def load_flat_npz(path: str) -> Dict[str, Any]:
    """Read a flat npz of '/'-joined keys into a nested dict of numpy
    arrays (``{"params": {...}, "batch_stats": {...}}``)."""
    out: Dict[str, Any] = {}
    with np.load(path) as blob:
        for key in blob.files:
            node = out
            parts = key.split(_SEP)
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = blob[key]
    return out


def flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict -> ``{'/'-joined path: array}``."""
    if hasattr(tree, "items"):
        out: Dict[str, np.ndarray] = {}
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}{k}{_SEP}"))
        return out
    return {prefix[:-1]: np.asarray(tree)}
