"""Miscellaneous utilities: the part of ``imitation_tpu/util/util.py`` the
port calls."""

from __future__ import annotations

import numpy as np


def oric(x: np.ndarray) -> np.ndarray:
    """Optimal rounding under integer constraints.

    Rounds each element so that the sum equals ``round(sum(x))`` while
    keeping the total rounding error least: floor everything, then add one
    to the entries with the largest fractional parts.
    """
    rounded = np.floor(x)
    shortfall = x - rounded
    deficit = int(np.round(np.sum(x) - np.sum(rounded)))
    indices = np.argsort(-shortfall)[:deficit]
    rounded[indices] += 1
    return rounded.astype(int)
