"""Filtering metrics: RMSE (paper eq. 24) and resample ratio (eq. 25),
copied from ``repro.pf.metrics``."""

from __future__ import annotations

import numpy as np


def rmse(estimates: np.ndarray, truth: np.ndarray) -> float:
    """Paper eq. (24) for a [K, T] batch of runs vs [T] truth (or [T] vs [T])."""
    est = np.asarray(estimates, np.float64)
    tru = np.asarray(truth, np.float64)
    if est.ndim == 1:
        est = est[None]
    # sqrt over the K Monte-Carlo axis first, then average over time.
    per_t = np.sqrt(np.mean((est - tru[None, :]) ** 2, axis=0))
    return float(np.mean(per_t))


def resample_ratio(times: dict) -> float:
    """tau_s2 / (tau_s1 + tau_s2 + tau_s3), eq. (25)."""
    total = times["predict_update"] + times["resample"] + times["estimate"]
    return times["resample"] / max(total, 1e-12)
