"""Replication statistics (`seeme_tpu/eval/stats.py`; the reference's
`test.py:32-38`): mean, 1.96 sigma / sqrt(n) confidence interval, min and
max over the REPLICATION_TIMES runs."""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def get_metric_statistics(replications: List[Dict[str, float]]) -> Dict[str, Dict[str, float]]:
    keys = sorted({k for rep in replications for k in rep})
    out: Dict[str, Dict[str, float]] = {}
    for k in keys:
        vals = np.array([rep[k] for rep in replications if k in rep], dtype=np.float64)
        n = len(vals)
        out[k] = {
            "mean": float(vals.mean()),
            "conf_interval": float(1.96 * vals.std() / np.sqrt(n)) if n > 1 else 0.0,
            "min": float(vals.min()),
            "max": float(vals.max()),
        }
    return out
