"""Evaluation reporting (JAX counterpart: etude_tpu/evaluation/reporting.py):
per-metric summary tables by version and a table of combined means, printed
through the logger, without pandas.

The numbers are those of the JAX package's `df.groupby("version")[metric]
.describe()` (count, mean, std with ddof 1, min, median, max; missing scores
skipped; versions in sorted order, then relabelled) and of its combined
means, rounded to 4 places.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..utils.logger import logger
from .runner import Row, columns

STATS = ("count", "mean", "std", "min", "50%", "max")
NAN = float("nan")


def describe(values: Sequence[Optional[float]]) -> Dict[str, float]:
    """pandas `Series.describe()`'s count, mean, std, min, 50% and max of
    the scores that are not missing."""
    x = np.array([v for v in values if v is not None and not math.isnan(v)],
                 dtype=np.float64)
    if x.size == 0:
        return {"count": 0.0, **dict.fromkeys(STATS[1:], NAN)}
    return {"count": float(x.size), "mean": float(x.mean()),
            "std": float(x.std(ddof=1)) if x.size > 1 else NAN,
            "min": float(x.min()), "50%": float(np.percentile(x, 50)),
            "max": float(x.max())}


class ReportGenerator:
    def __init__(self, version_labels: Optional[Dict[str, str]] = None):
        self.version_labels = version_labels or {}

    def summary(self, rows: Sequence[Row]) -> Dict[str, Dict[str, Dict[str, float]]]:
        """{metric: {version label: describe numbers}}, unrounded."""
        metrics = [c for c in ("wpd", "rgc", "ipe") if c in columns(rows)]
        versions = sorted({row["version"] for row in rows})
        return {m: {self.version_labels.get(v, v):
                    describe([r.get(m) for r in rows if r["version"] == v])
                    for v in versions}
                for m in metrics}

    def print_summary(self, rows: Sequence[Row]) -> Optional[Dict[str, Dict[str, float]]]:
        """Prints the tables; returns {version label: {metric: mean rounded
        to 4 places}} (the JAX package's combined table), None when there
        are no rows."""
        if not rows:
            logger.warn("no evaluation results to report")
            return None
        tables = self.summary(rows)
        for metric, table in tables.items():
            logger.stage(f"{metric.upper()} summary")
            for line in _format(table, STATS):
                logger.info(line)

        logger.stage("Combined means")
        combined = {label: {m: round(tables[m][label]["mean"], 4) for m in tables}
                    for label in next(iter(tables.values()), {})}
        for line in _format(combined, list(tables)):
            logger.info(line)
        return combined


def _format(table: Dict[str, Dict[str, float]], keys: Sequence[str]) -> List[str]:
    width = max([len("version")] + [len(k) for k in table])
    lines = ["version".ljust(width) + "".join(f"{k:>12s}" for k in keys)]
    for label, stats in table.items():
        lines.append(label.ljust(width)
                     + "".join(f"{round(stats[k], 4):>12.4f}" for k in keys))
    return lines
