"""rliable-style statistics over per-seed scores, in numpy.

Port of ``benchmarking/summarize.py:29-64``: the interquartile mean, a
percentile-bootstrap confidence interval and the probability of improvement,
as Agarwal et al. (2021) define them and ``rliable`` computes them. The rest
of that module summarizes the JAX package's run directories and is not
ported.
"""

from __future__ import annotations

import numpy as np


def iqm(scores: np.ndarray) -> float:
    """Interquartile mean: mean of the middle 50% of scores."""
    scores = np.sort(np.asarray(scores, np.float64))
    n = len(scores)
    lo, hi = int(np.floor(n * 0.25)), int(np.ceil(n * 0.75))
    mid = scores[lo:hi]
    return float(mid.mean()) if len(mid) else float(scores.mean())


def bootstrap_ci(
    scores: np.ndarray,
    statistic=iqm,
    n_resamples: int = 2000,
    alpha: float = 0.05,
    seed: int = 0,
) -> tuple:
    """The ``(alpha / 2, 1 - alpha / 2)`` percentiles of ``statistic`` over
    ``n_resamples`` resamples of ``scores`` with replacement, drawn from
    ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    scores = np.asarray(scores, np.float64)
    stats = [
        statistic(rng.choice(scores, size=len(scores), replace=True))
        for _ in range(n_resamples)
    ]
    return (
        float(np.percentile(stats, 100 * alpha / 2)),
        float(np.percentile(stats, 100 * (1 - alpha / 2))),
    )


def probability_of_improvement(x_scores: np.ndarray, y_scores: np.ndarray) -> float:
    """P(X > Y) over all run pairs (ties count half), the rliable definition."""
    x = np.asarray(x_scores, np.float64)[:, None]
    y = np.asarray(y_scores, np.float64)[None, :]
    return float(((x > y).mean() + 0.5 * (x == y).mean()))
