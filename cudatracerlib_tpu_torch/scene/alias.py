"""Walker/Vose alias tables for O(1) discrete sampling (host-side numpy).

Verbatim port of ``cudatracerlib_tpu/scene/alias.py``: one table row
[prob, alias_id, pmf_self, pmf_alias] per outcome, so a draw is one row
gather on the device. The tables are byte-identical to the JAX build's.
"""
from __future__ import annotations

import numpy as np


def build_alias_table(weights: np.ndarray) -> np.ndarray:
    """(N,) nonneg weights -> (N, 4) f32 [prob, alias_idx(bits), pmf_self,
    pmf_alias] rows. pmf is the normalized selection probability of the
    corresponding OUTCOME (used directly as the sampling pdf)."""
    w = np.asarray(weights, np.float64).ravel()
    n = w.size
    s = w.sum()
    if not np.isfinite(s) or s <= 0:
        pmf = np.full(n, 1.0 / n, np.float64)
    else:
        pmf = w / s
    scaled = pmf * n
    prob = np.ones(n, np.float64)
    alias = np.arange(n, dtype=np.int64)
    small = [i for i in range(n) if scaled[i] < 1.0]
    large = [i for i in range(n) if scaled[i] >= 1.0]
    while small and large:
        s_i = small.pop()
        l_i = large.pop()
        prob[s_i] = scaled[s_i]
        alias[s_i] = l_i
        scaled[l_i] = (scaled[l_i] + scaled[s_i]) - 1.0
        (small if scaled[l_i] < 1.0 else large).append(l_i)
    for i in small + large:
        prob[i] = 1.0
        alias[i] = i
    out = np.empty((n, 4), np.float32)
    out[:, 0] = prob
    out[:, 1] = alias.astype(np.int32).view(np.float32)
    out[:, 2] = pmf
    out[:, 3] = pmf[alias]
    return out
