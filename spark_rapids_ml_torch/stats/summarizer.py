#
# The summarizer: the port of spark_rapids_ml_tpu/stats/summarizer.py, the
# reference-compatible face of the statistic-program engine (the analog of
# `pyspark.ml.stat.Summarizer` and `DataFrame.describe()`).
# `summarize(data, metrics=[...])` maps every requested metric to its
# registered program, runs the union of the programs in ONE pass
# (stats/engine.py), and maps the finalized statistics back onto the
# metric names: mean + variance + min + max + quantiles + distinctCount is
# one scan, not six.
#
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np

# metric name -> (program, result key); metrics mapping to the same
# program share its single accumulator in the fused pass
_METRICS: Dict[str, tuple] = {
    "count": ("moments", "count"),
    "weightSum": ("moments", "weight_sum"),
    "mean": ("moments", "mean"),
    "sum": ("moments", "sum"),
    "variance": ("moments", "variance"),
    "std": ("moments", "std"),
    "min": ("moments", "min"),
    "max": ("moments", "max"),
    "normL1": ("moments", "norm_l1"),
    "normL2": ("moments", "norm_l2"),
    "numNonZeros": ("moments", "num_nonzeros"),
    "covariance": ("covariance", "covariance"),
    "correlation": ("covariance", "correlation"),
    "standardization": ("standardization", None),
    "quantiles": ("quantile_sketch", "quantiles"),
    "median": ("quantile_sketch", None),
    "frequentItems": ("frequent_items", None),
    "distinctCount": ("distinct_count", "distinct"),
    "ttest": ("ttest", None),
    "chi2": ("chi2", None),
}

SUPPORTED_METRICS = frozenset(_METRICS)


def summarize(
    data,
    metrics: Sequence[str] = ("count", "mean", "variance"),
    *,
    features_col: Optional[str] = "features",
    features_cols: Sequence[str] = (),
    label_col: Optional[str] = None,
    weight_col: Optional[str] = None,
    quantiles: Sequence[float] = (0.25, 0.5, 0.75),
    dtype=None,
    device=None,
) -> Dict[str, Any]:
    """Compute every requested metric in ONE pass over `data` (a numpy
    batch, `(X, y)` tuple, pandas frame, or parquet path) on `device`
    (default: the default device).  Returns `{metric: value}`;
    vector-valued metrics are per-column arrays in column order."""
    from .engine import run_programs

    metrics = list(dict.fromkeys(metrics))
    unknown = [m for m in metrics if m not in _METRICS]
    if unknown:
        raise ValueError(
            f"unknown summarizer metrics {unknown}; supported: "
            + ", ".join(sorted(_METRICS))
        )
    programs = list(dict.fromkeys(_METRICS[m][0] for m in metrics))
    qs = list(dict.fromkeys(float(q) for q in quantiles))
    if "median" in metrics and 0.5 not in qs:
        qs.append(0.5)
    results = run_programs(
        programs, data,
        features_col=features_col, features_cols=features_cols,
        label_col=label_col, weight_col=weight_col,
        dtype=dtype, quantiles=qs, label="summarize", device=device,
    )
    out: Dict[str, Any] = {}
    for m in metrics:
        prog, key = _METRICS[m]
        r = results[prog]
        if m == "median":
            out[m] = r["quantiles"][0.5]
        elif m == "frequentItems":
            out[m] = r["items"]
        elif key is None:
            out[m] = r
        else:
            out[m] = r[key]
    return out


class Summarizer:
    """Reference-style metric builder: ``Summarizer.metrics("mean",
    "variance").summary(df)`` computes the requested metrics in one
    fused pass.  `describe` is the `DataFrame.describe()` analog."""

    def __init__(self, *metric_names: str) -> None:
        self._metrics = list(metric_names) or ["count", "mean", "variance"]

    @classmethod
    def metrics(cls, *metric_names: str) -> "Summarizer":
        return cls(*metric_names)

    def summary(self, data, **kwargs) -> Dict[str, Any]:
        return summarize(data, metrics=self._metrics, **kwargs)

    @staticmethod
    def describe(
        data,
        *,
        features_col: Optional[str] = "features",
        features_cols: Sequence[str] = (),
        weight_col: Optional[str] = None,
        column_names: Optional[Sequence[str]] = None,
        device=None,
    ):
        """`DataFrame.describe()`-style summary table: one fused pass
        computing count/mean/std/min/25%/50%/75%/max, returned as a
        pandas DataFrame with one column per feature."""
        import pandas as pd

        s = summarize(
            data,
            metrics=("count", "mean", "std", "min", "quantiles", "max"),
            features_col=features_col, features_cols=features_cols,
            weight_col=weight_col, quantiles=(0.25, 0.5, 0.75),
            device=device,
        )
        d = int(np.asarray(s["mean"]).shape[0])
        if column_names is None:
            column_names = (
                list(features_cols)
                if features_cols
                else [f"x{i}" for i in range(d)]
            )
        rows = {
            "count": np.full((d,), s["count"], np.float64),
            "mean": np.asarray(s["mean"]),
            "std": np.asarray(s["std"]),
            "min": np.asarray(s["min"]),
            "25%": np.asarray(s["quantiles"][0.25]),
            "50%": np.asarray(s["quantiles"][0.5]),
            "75%": np.asarray(s["quantiles"][0.75]),
            "max": np.asarray(s["max"]),
        }
        return pd.DataFrame(rows, index=list(column_names)).T


def describe(data, **kwargs):
    """Module-level convenience over `Summarizer.describe`."""
    return Summarizer.describe(data, **kwargs)
