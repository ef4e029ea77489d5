"""Statistical reward-improvement assertions for learning tests.

Port of ``imitation_tpu/testing/reward_improvement.py`` (numpy only):
instead of golden values, learning tests assert that post-training episode
returns are a *statistically significant* improvement over pre-training
returns, by a one-sided permutation test on the difference of means.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np


def mean_difference_p_value(
    old: np.ndarray, new: np.ndarray, n_resamples: int = 9999, seed: int = 0
) -> float:
    """One-sided permutation p-value for mean(new) > mean(old)."""
    old = np.asarray(old, dtype=np.float64)
    new = np.asarray(new, dtype=np.float64)
    observed = new.mean() - old.mean()
    pooled = np.concatenate([old, new])
    n_old = len(old)
    rng = np.random.default_rng(seed)
    count = 0
    for _ in range(n_resamples):
        perm = rng.permutation(pooled)
        stat = perm[n_old:].mean() - perm[:n_old].mean()
        if stat >= observed:
            count += 1
    return (count + 1) / (n_resamples + 1)


def is_significant_reward_improvement(
    old_rewards: Iterable[float],
    new_rewards: Iterable[float],
    p_value: float = 0.05,
    n_resamples: int = 999,
) -> bool:
    """True iff new returns significantly exceed old."""
    return (
        mean_difference_p_value(
            np.asarray(list(old_rewards)), np.asarray(list(new_rewards)), n_resamples
        )
        < p_value
    )
