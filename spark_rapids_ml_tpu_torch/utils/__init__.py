#
# Small host helpers the port keeps its own copies of (the JAX package's
# spark_rapids_ml_tpu/utils/__init__.py holds the originals).
#
from __future__ import annotations

import numpy as np

__all__ = ["unit_rows"]


def unit_rows(x: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    """Rows scaled to unit L2 norm, in float32, with a zero-norm guard: the
    cosine convention of the ANN index, its queries and its refine. Zero
    rows stay zero, so against unit index vectors a zero row's squared
    euclidean distance is 1 and its cosine distance (d²/2) 0.5 to every
    item: equidistant, hence ranking-neutral, but not sklearn's 1.0 for
    zero vectors."""
    x = np.asarray(x, np.float32)
    return x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), eps)
