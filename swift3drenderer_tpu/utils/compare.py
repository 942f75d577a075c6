"""Frame comparison for golden-frame differential checks."""

from __future__ import annotations

import numpy as np


def pixel_mismatch_fraction(a: np.ndarray, b: np.ndarray, tol: int = 1) -> float:
    """Fraction of pixels whose packed RGB differs by more than ``tol`` in any
    channel. Comparator for golden-frame differential tests."""
    if a.shape != b.shape:
        raise ValueError(f"frame shapes differ: {a.shape} vs {b.shape}")

    def channels(p):
        p = np.asarray(p).astype(np.int64)
        return np.stack([(p >> 16) & 255, (p >> 8) & 255, p & 255], axis=-1)

    diff = np.abs(channels(a) - channels(b)).max(axis=-1)
    return float((diff > tol).mean())
