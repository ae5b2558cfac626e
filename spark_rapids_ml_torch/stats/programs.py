#
# Statistic programs: the port of spark_rapids_ml_tpu/stats/programs.py.  A
# program is four functions over fixed-shape `(X, w[, y])` chunks:
#
#   init(d, dtype, opts, device)   a fresh accumulator dict (declared shapes)
#   step(acc, X, w[, y])           fold one chunk (device programs: torch
#                                  tensors on the chunk's device, updated in
#                                  place and returned; host programs: numpy)
#   merge(a, b)                    combine two host-side partial accumulators
#                                  (device programs by each field's declared
#                                  mode: sum | min | max)
#   finalize(host_acc, ctx)        accumulator -> the user-facing statistics
#
# Programs register in `STAT_PROGRAMS` with declared accumulator shapes and
# dtypes; the declaration is checked against a probe init the first time a
# program is fetched (`get_program`).  The engine (stats/engine.py) folds
# any set of them in one pass.  The moment and product steps reuse
# ops/stats.py (its accumulators and `_kahan_add` carries), so the fused and
# streamed passes and the programs share one owner of that arithmetic.
#
# The JAX package's HyperLogLog step multiplies uint32 values and counts
# leading zeros with `lax.clz`; torch has neither on CUDA, so the port
# computes in int64 masked to 32 bits (products split in 16-bit halves, so
# no int64 product overflows) and counts leading zeros by a fixed binary
# search.  Its registers equal the JAX package's bit for bit.
#
from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np

from ..config import get_config
from ..ops.stats import CARRY_SUFFIX, _kahan_add


class Field(NamedTuple):
    """One declared accumulator field: shape (in terms of the feature
    dimension d), dtype (None: the accumulation dtype), and how two partial
    accumulators combine on it."""

    shape: Tuple[int, ...]
    dtype: Optional[str] = None
    merge: str = "sum"  # sum | min | max | slot (host, slot-disjoint)


@dataclass(frozen=True)
class StatProgram:
    """A registered statistic program.  `kind` is "device" (a torch step on
    the chunk's device, folded in the engine's combined step) or "host" (a
    numpy step on the decoded chunk: the mergeable sketches, whose
    data-dependent updates have no fixed-shape form).  `make_step(d, dtype,
    opts)` returns `(weighted_step, unweighted_step_or_None)` for a device
    program and one `step(acc, X, w, y, ctx)` for a host program."""

    name: str
    kind: str
    shapes: Callable[[int, Dict[str, Any]], Dict[str, Field]]
    init: Callable[..., Dict[str, Any]]
    make_step: Callable[[int, Any, Dict[str, Any]], Any]
    finalize: Callable[[Dict[str, Any], Dict[str, Any]], Dict[str, Any]]
    merge: Optional[Callable[..., Dict[str, Any]]] = None
    needs_y: bool = False
    mergeable: bool = True
    # the stats_precision levels the device step honours
    precision_modes: Tuple[str, ...] = ("exact",)
    doc: str = ""
    opts_defaults: Dict[str, Any] = dc_field(default_factory=dict)
    # resolves conf-derived options (sketch sizes, bin counts) into explicit
    # entries, so each run sees the effective geometry
    resolve: Optional[Callable[[Dict[str, Any]], Dict[str, Any]]] = None
    # extra per-pass step arguments (the range-finder's omega): such programs
    # run only through their own callers (fused.py), not the engine
    extra_args: Tuple[str, ...] = ()


STAT_PROGRAMS: Dict[str, StatProgram] = {}

_PROBE_D = 3

# programs whose declaration was checked against a probe init
_VALIDATED: set = set()


def register_program(p: StatProgram) -> StatProgram:
    """Register a program; its declaration is checked against a probe init
    the first time it is fetched (`get_program`)."""
    if p.name in STAT_PROGRAMS:
        raise ValueError(f"statistic program {p.name!r} already registered")
    if p.kind not in ("device", "host"):
        raise ValueError(f"program {p.name!r}: kind must be device|host")
    STAT_PROGRAMS[p.name] = p
    return p


def _np_dtype(v) -> np.dtype:
    import torch

    if isinstance(v, torch.Tensor):
        return torch.empty(0, dtype=v.dtype).numpy().dtype
    return np.dtype(np.asarray(v).dtype)


def _validate(p: StatProgram) -> None:
    """Probe-init at d=3 (float32, on the CPU) and compare with the
    declaration."""
    opts = resolve_opts(p, None)
    declared = p.shapes(_PROBE_D, opts)
    acc = p.init(_PROBE_D, np.float32, opts)
    got = {k: v for k, v in acc.items() if not k.endswith(CARRY_SUFFIX)}
    if set(got) != set(declared):
        raise ValueError(
            f"program {p.name!r}: init fields {sorted(got)} != declared {sorted(declared)}")
    for fname, spec in declared.items():
        v = got[fname]
        if tuple(v.shape) != tuple(spec.shape):
            raise ValueError(f"program {p.name!r}: field {fname!r} shape {tuple(v.shape)} != "
                             f"declared {tuple(spec.shape)}")
        want = np.dtype(spec.dtype or np.float32)
        if _np_dtype(v) != want:
            raise ValueError(f"program {p.name!r}: field {fname!r} dtype {_np_dtype(v)} != "
                             f"declared {want}")


def get_program(name: str) -> StatProgram:
    p = STAT_PROGRAMS.get(name)
    if p is None:
        raise KeyError(f"unknown statistic program {name!r}; registered: "
                       + ", ".join(sorted(STAT_PROGRAMS)))
    if name not in _VALIDATED:
        _validate(p)
        _VALIDATED.add(name)
    return p


def merge_accs(p: StatProgram, a: Dict[str, Any], b: Dict[str, Any],
               opts: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Combine two host-side partial accumulators of one program: a host
    program's own merge, else field by field by the declared mode."""
    if not p.mergeable:
        raise ValueError(f"program {p.name!r} is not mergeable")
    if p.merge is not None:
        return p.merge(a, b, resolve_opts(p, opts))
    declared = p.shapes(_infer_d(p, a), resolve_opts(p, opts))
    out: Dict[str, Any] = {}
    for k, v in a.items():
        if k.endswith(CARRY_SUFFIX):
            continue
        mode = declared[k].merge
        if mode == "sum":
            out[k] = np.asarray(v) + np.asarray(b[k])
        elif mode == "min":
            out[k] = np.minimum(v, b[k])
        elif mode == "max":
            out[k] = np.maximum(v, b[k])
        else:
            raise ValueError(f"program {p.name!r}: field {k!r} merge mode {mode!r}")
    return out


def resolve_opts(p: StatProgram, opts: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """Effective options: defaults, the caller's overrides, then the
    program's conf resolution."""
    merged = dict(p.opts_defaults)
    merged.update(opts or {})
    if p.resolve is not None:
        merged = p.resolve(merged)
    return merged


def _infer_d(p: StatProgram, acc: Dict[str, Any]) -> int:
    """The feature dimension of a host accumulator, read off a field whose
    declared shape leads with d."""
    for fname, spec in p.shapes(_PROBE_D, resolve_opts(p, None)).items():
        if spec.shape and spec.shape[0] == _PROBE_D:
            return int(np.shape(acc[fname])[0])
    return _PROBE_D


def _zeros(shapes: Dict[str, Field], d_actual: Dict[str, Field], dtype,
           compensated_fields: Tuple[str, ...] = (), device=None):
    """A zero accumulator on `device` with the per-field dtypes (min fields
    start at +inf, max fields at -inf), with Kahan carry twins on the
    compensated sum fields when `stats_precision` asks for them."""
    import torch

    from ..ops.precision import stats_compensated
    from ..parallel.mesh import _torch_dtype

    del shapes  # the declared probe shapes; d_actual holds the real ones
    comp = stats_compensated()
    acc = {}
    for k, spec in d_actual.items():
        dt = _torch_dtype(np.dtype(spec.dtype or dtype))
        if spec.merge == "min":
            acc[k] = torch.full(spec.shape, float("inf"), dtype=dt, device=device)
        elif spec.merge == "max":
            acc[k] = torch.full(spec.shape, float("-inf"), dtype=dt, device=device)
        else:
            acc[k] = torch.zeros(spec.shape, dtype=dt, device=device)
        if comp and k in compensated_fields:
            acc[k + CARRY_SUFFIX] = torch.zeros(spec.shape, dtype=dt, device=device)
    return acc


# ---------------------------------------------------------------------------
# column moments, min, max (count, mean, variance, std, norms, nonzeros)
# ---------------------------------------------------------------------------

_MOMENT_COMP = ("sw", "s1", "s2", "l1")


def _moments_shapes(d: int, opts: Dict[str, Any]) -> Dict[str, Field]:
    return {
        "sw": Field(()),
        "n": Field((), "int32"),
        "s1": Field((d,)),
        "s2": Field((d,)),
        "l1": Field((d,)),
        "nnz": Field((d,), "int32"),
        "min": Field((d,), merge="min"),
        "max": Field((d,), merge="max"),
    }


def _moments_init(d: int, dtype, opts: Dict[str, Any], device=None):
    return _zeros(_moments_shapes(_PROBE_D, opts), _moments_shapes(d, opts), dtype,
                  _MOMENT_COMP, device)


def _moments_make_step(d: int, dtype, opts: Dict[str, Any]):
    def step(acc, X, w):
        import torch

        valid = w > 0
        Xw = X * w[:, None]
        _kahan_add(acc, "s1", Xw.sum(dim=0))
        _kahan_add(acc, "s2", (Xw * X).sum(dim=0))
        del Xw
        _kahan_add(acc, "l1", (X.abs() * w[:, None]).sum(dim=0))
        _kahan_add(acc, "sw", w.sum())
        # exact integer counts (float32 would round past 2^24 rows)
        acc["n"] += valid.sum(dtype=torch.int32)
        acc["nnz"] += ((X != 0) & valid[:, None]).sum(dim=0, dtype=torch.int32)
        inf = torch.tensor(float("inf"), dtype=X.dtype, device=X.device)
        torch.minimum(acc["min"], torch.where(valid[:, None], X, inf).amin(dim=0),
                      out=acc["min"])
        torch.maximum(acc["max"], torch.where(valid[:, None], X, -inf).amax(dim=0),
                      out=acc["max"])
        return acc

    return step, None


def _moments_finalize(acc: Dict[str, Any], ctx: Dict[str, Any]):
    sw = float(acc["sw"])
    mean = np.asarray(acc["s1"]) / max(sw, 1e-300)
    # Spark's MultivariateOnlineSummarizer variance: the weighted central
    # moment over max(sw - 1, 1)
    var = (np.asarray(acc["s2"]) - sw * mean * mean) / max(sw - 1.0, 1.0)
    var = np.maximum(var, 0.0)
    return {
        "count": int(acc["n"]),
        "weight_sum": sw,
        "mean": mean,
        "sum": np.asarray(acc["s1"]),
        "variance": var,
        "std": np.sqrt(var),
        "min": np.asarray(acc["min"]),
        "max": np.asarray(acc["max"]),
        "norm_l1": np.asarray(acc["l1"]),
        "norm_l2": np.sqrt(np.maximum(np.asarray(acc["s2"]), 0.0)),
        "num_nonzeros": np.asarray(acc["nnz"]),
    }


register_program(StatProgram(
    name="moments",
    kind="device",
    shapes=_moments_shapes,
    init=_moments_init,
    make_step=_moments_make_step,
    finalize=_moments_finalize,
    precision_modes=("exact", "high_compensated"),
    doc="per-column count/mean/variance/std/min/max/norms/nonzeros",
))


def _standardization_finalize(acc: Dict[str, Any], ctx: Dict[str, Any]):
    """The solvers' standardization: a zero-variance column scales by 1."""
    out = _moments_finalize(acc, ctx)
    std = np.where(out["std"] == 0.0, 1.0, out["std"])
    return {"mean": out["mean"], "std": std, "weight_sum": out["weight_sum"]}


register_program(StatProgram(
    name="standardization",
    kind="device",
    shapes=_moments_shapes,
    init=_moments_init,
    make_step=_moments_make_step,
    finalize=_standardization_finalize,
    precision_modes=("exact", "high_compensated"),
    doc="solver standardization mean/std (zero-variance columns -> 1.0)",
))


# ---------------------------------------------------------------------------
# covariance and correlation (the PCA second-moment accumulator)
# ---------------------------------------------------------------------------


def _second_moment_shapes(d: int, opts: Dict[str, Any]) -> Dict[str, Field]:
    return {"S": Field((d, d)), "s1": Field((d,)), "sw": Field(())}


def _second_moment_init(d: int, dtype, opts: Dict[str, Any], device=None):
    from ..ops.stats import pca_moment_acc

    acc, _ = pca_moment_acc(d, np.dtype(dtype), device)
    return acc


def _second_moment_make_step(d: int, dtype, opts: Dict[str, Any]):
    from ..ops.stats import pca_moment_acc, pca_moment_step_unw

    _, step = pca_moment_acc(d, np.dtype(dtype))
    return step, pca_moment_step_unw


def _covariance_finalize(acc: Dict[str, Any], ctx: Dict[str, Any]):
    sw = float(acc["sw"])
    mean = np.asarray(acc["s1"]) / max(sw, 1e-300)
    cov = (np.asarray(acc["S"]) - sw * np.outer(mean, mean)) / max(sw - 1.0, 1.0)
    cov = (cov + cov.T) / 2.0  # symmetrize away the accumulation's rounding
    sd = np.sqrt(np.maximum(np.diag(cov), 0.0))
    denom = np.outer(sd, sd)
    corr = np.divide(cov, denom, out=np.full_like(cov, np.nan), where=denom > 0)
    np.fill_diagonal(corr, 1.0)
    return {"mean": mean, "covariance": cov, "correlation": corr, "weight_sum": sw}


register_program(StatProgram(
    name="covariance",
    kind="device",
    shapes=_second_moment_shapes,
    init=_second_moment_init,
    make_step=_second_moment_make_step,
    finalize=_covariance_finalize,
    precision_modes=("exact", "high_compensated"),
    doc="covariance + correlation matrices from one Gram pass",
))


# ---------------------------------------------------------------------------
# the estimators' accumulators (ops/stats.py), registered
# ---------------------------------------------------------------------------


register_program(StatProgram(
    name="pca_moments",
    kind="device",
    shapes=_second_moment_shapes,
    init=_second_moment_init,
    make_step=_second_moment_make_step,
    finalize=lambda acc, ctx: dict(acc),  # PCA._attrs_from_moments reads S/s1/sw
    precision_modes=("exact", "high_compensated"),
    doc="PCA exact second moments (ops/stats.py pca_moment_acc)",
))


def _pca_projected_shapes(d: int, opts: Dict[str, Any]) -> Dict[str, Field]:
    l = int(opts.get("l", 8))
    return {"SOm": Field((d, l)), "s1": Field((d,)), "ssq": Field((d,)), "sw": Field(())}


def _pca_projected_init(d: int, dtype, opts: Dict[str, Any], device=None):
    from ..ops.stats import pca_projected_acc

    acc, _ = pca_projected_acc(d, int(opts.get("l", 8)), np.dtype(dtype), device)
    return acc


def _pca_projected_make_step(d: int, dtype, opts: Dict[str, Any]):
    from ..ops.stats import pca_projected_acc, pca_projected_step_unw

    _, step = pca_projected_acc(d, int(opts.get("l", 8)), np.dtype(dtype))
    return step, pca_projected_step_unw


register_program(StatProgram(
    name="pca_projected",
    kind="device",
    shapes=_pca_projected_shapes,
    init=_pca_projected_init,
    make_step=_pca_projected_make_step,
    finalize=lambda acc, ctx: dict(acc),
    precision_modes=("exact", "high_compensated"),
    doc="randomized-PCA projected moments (takes the range-finder's omega as an extra "
        "step argument)",
    opts_defaults={"l": 8},
    extra_args=("omega",),
))


def _linreg_shapes(d: int, opts: Dict[str, Any]) -> Dict[str, Field]:
    return {"gram": Field((d, d)), "sxy": Field((d,)), "s1": Field((d,)), "sw": Field(()),
            "sy": Field(()), "syy": Field(())}


def _linreg_init(d: int, dtype, opts: Dict[str, Any], device=None):
    from ..ops.stats import linreg_acc

    acc, _ = linreg_acc(d, np.dtype(dtype), device)
    return acc


def _linreg_make_step(d: int, dtype, opts: Dict[str, Any]):
    from ..ops.stats import linreg_acc, linreg_step_unw

    _, step = linreg_acc(d, np.dtype(dtype))
    return step, linreg_step_unw


register_program(StatProgram(
    name="linreg",
    kind="device",
    shapes=_linreg_shapes,
    init=_linreg_init,
    make_step=_linreg_make_step,
    finalize=lambda acc, ctx: dict(acc),
    needs_y=True,
    precision_modes=("exact", "high_compensated"),
    doc="weighted Gram/moment/cross statistics (ops/stats.py linreg_acc)",
))


# ---------------------------------------------------------------------------
# hypothesis tests: grouped moments (t-test) and contingency (chi-squared)
# ---------------------------------------------------------------------------


def _grouped_shapes(d: int, opts: Dict[str, Any]) -> Dict[str, Field]:
    return {"gn": Field((2,)), "gs1": Field((2, d)), "gs2": Field((2, d))}


def _grouped_init(d: int, dtype, opts: Dict[str, Any], device=None):
    return _zeros(_grouped_shapes(_PROBE_D, opts), _grouped_shapes(d, opts), dtype,
                  ("gs1", "gs2"), device)


def _grouped_make_step(d: int, dtype, opts: Dict[str, Any]):
    def step(acc, X, w, y):
        import torch

        from ..ops.precision import stats_matmul

        g1 = (y > 0.5).to(X.dtype)
        gw = torch.stack([w * (1.0 - g1), w * g1])  # (2, rows)
        acc["gn"] += gw.sum(dim=1)
        with stats_matmul():
            _kahan_add(acc, "gs1", gw @ X)
            _kahan_add(acc, "gs2", gw @ (X * X))
        return acc

    return step, None


def _ttest_finalize(acc: Dict[str, Any], ctx: Dict[str, Any]):
    """Per-column Welch two-sample t-test between label groups 0 and 1."""
    n = np.asarray(acc["gn"], np.float64)  # (2,)
    s1 = np.asarray(acc["gs1"], np.float64)
    s2 = np.asarray(acc["gs2"], np.float64)
    mean = s1 / np.maximum(n[:, None], 1e-300)
    var = (s2 - n[:, None] * mean * mean) / np.maximum(n[:, None] - 1.0, 1.0)
    var = np.maximum(var, 0.0)
    se2 = var[0] / max(n[0], 1.0) + var[1] / max(n[1], 1.0)
    t = (mean[0] - mean[1]) / np.sqrt(np.maximum(se2, 1e-300))
    df_num = se2 * se2
    df_den = ((var[0] / max(n[0], 1.0)) ** 2 / max(n[0] - 1.0, 1.0)
              + (var[1] / max(n[1], 1.0)) ** 2 / max(n[1] - 1.0, 1.0))
    df = df_num / np.maximum(df_den, 1e-300)
    return {"t": t, "df": df, "p_value": _t_sf(np.abs(t), df) * 2.0, "group_counts": n,
            "group_means": mean, "group_variances": var}


def _t_sf(t: np.ndarray, df: np.ndarray) -> np.ndarray:
    try:
        from scipy.stats import t as t_dist

        return t_dist.sf(t, np.maximum(df, 1e-9))
    except ImportError:  # pragma: no cover - scipy is installed where the port runs
        from math import erf, sqrt

        return np.asarray([0.5 * (1.0 - erf(float(x) / sqrt(2.0)))
                           for x in np.ravel(t)]).reshape(np.shape(t))


register_program(StatProgram(
    name="ttest",
    kind="device",
    shapes=_grouped_shapes,
    init=_grouped_init,
    make_step=_grouped_make_step,
    finalize=_ttest_finalize,
    needs_y=True,
    precision_modes=("exact", "high_compensated"),
    doc="per-column Welch two-sample t-test between label groups 0/1",
))


def _contingency_bins(opts: Dict[str, Any]) -> int:
    return int(opts.get("bins") or get_config("summarizer_chi2_bins"))


def _contingency_shapes(d: int, opts: Dict[str, Any]) -> Dict[str, Field]:
    b = _contingency_bins(opts)
    return {"counts": Field((d, b, b))}


def _contingency_init(d: int, dtype, opts: Dict[str, Any], device=None):
    return _zeros(_contingency_shapes(_PROBE_D, opts), _contingency_shapes(d, opts), dtype,
                  device=device)


def _contingency_make_step(d: int, dtype, opts: Dict[str, Any]):
    b = _contingency_bins(opts)

    def step(acc, X, w, y):
        import torch

        counts = acc["counts"]
        xi = torch.clamp(torch.round(X).to(torch.int64), 0, b - 1)
        yi = torch.clamp(torch.round(y).to(torch.int64), 0, b - 1)
        cols = torch.arange(X.shape[1], dtype=torch.int64, device=X.device)[None, :]
        idx = (cols * (b * b) + xi * b + yi[:, None]).reshape(-1)
        upd = w[:, None].to(counts.dtype).expand(xi.shape).reshape(-1)
        counts.view(-1).index_add_(0, idx, upd)
        return acc

    return step, None


def _chi2_finalize(acc: Dict[str, Any], ctx: Dict[str, Any]):
    """Per-column chi-squared test of independence between the feature
    (integer-coded, clipped to `summarizer_chi2_bins`) and the label."""
    counts = np.asarray(acc["counts"], np.float64)
    d = counts.shape[0]
    stat = np.zeros((d,))
    dof = np.zeros((d,), np.int64)
    p = np.ones((d,))
    for j in range(d):
        O = counts[j]
        O = O[O.sum(axis=1) > 0][:, O.sum(axis=0) > 0]
        if O.shape[0] < 2 or O.shape[1] < 2:
            continue
        n = O.sum()
        E = np.outer(O.sum(axis=1), O.sum(axis=0)) / n
        stat[j] = float(((O - E) ** 2 / E).sum())
        dof[j] = (O.shape[0] - 1) * (O.shape[1] - 1)
        p[j] = _chi2_sf(stat[j], int(dof[j]))
    return {"statistic": stat, "dof": dof, "p_value": p}


def _chi2_sf(x: float, dof: int) -> float:
    try:
        from scipy.stats import chi2 as chi2_dist

        return float(chi2_dist.sf(x, dof))
    except ImportError:  # pragma: no cover - scipy is installed where the port runs
        from math import exp

        return float(exp(-x / 2.0))


register_program(StatProgram(
    name="chi2",
    kind="device",
    shapes=_contingency_shapes,
    init=_contingency_init,
    make_step=_contingency_make_step,
    finalize=_chi2_finalize,
    needs_y=True,
    doc="per-column chi-squared independence test vs the label (binned contingency counts)",
    resolve=lambda opts: dict(opts, bins=_contingency_bins(opts)),
))


# ---------------------------------------------------------------------------
# HyperLogLog distinct counts (device; int32 registers)
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _hll_bits(opts: Dict[str, Any]) -> int:
    return int(opts.get("bits") or get_config("summarizer_hll_bits"))


def _hll_shapes(d: int, opts: Dict[str, Any]) -> Dict[str, Field]:
    return {"regs": Field((d, 2 ** _hll_bits(opts)), "int32", merge="max")}


def _hll_init(d: int, dtype, opts: Dict[str, Any], device=None):
    import torch

    return {"regs": torch.zeros((d, 2 ** _hll_bits(opts)), dtype=torch.int32, device=device)}


def _mul32(h, c: int):
    """(h * c) mod 2^32 for int64 h in [0, 2^32): the low and high 16-bit
    halves of h are multiplied apart, so that no product passes 2^48."""
    return ((h & 0xFFFF) * c + ((((h >> 16) * c) & 0xFFFF) << 16)) & _M32


def _clz32(x):
    """Leading zeros of the 32-bit values in int64 x (32 for 0), by a fixed
    binary search."""
    import torch

    n = torch.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        top_clear = x <= (_M32 >> s)  # the top s of the 32 bits are 0
        n += top_clear * s
        x = torch.where(top_clear, x << s, x)
    return n + (x >> 31 == 0)


def hll_hash_rank(X, p_bits: int):
    """(bucket, rank) of every value, the JAX package's hash: -0.0 made
    +0.0, the float32 bit pattern through murmur3's finalizer, the top
    `p_bits` bits the bucket, 1 + the leading zeros of the rest (at most
    33 - p_bits) the rank."""
    import torch

    h = (X + 0.0).to(torch.float32).contiguous().view(torch.int32).to(torch.int64) & _M32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    bucket = h >> (32 - p_bits)
    rest = (h << p_bits) & _M32
    rho = torch.clamp(_clz32(rest) + 1, max=32 - p_bits + 1)
    return bucket, rho


def _hll_make_step(d: int, dtype, opts: Dict[str, Any]):
    p_bits = _hll_bits(opts)
    m = 2 ** p_bits

    def step(acc, X, w):
        import torch

        bucket, rho = hll_hash_rank(X, p_bits)
        rho = torch.where((w > 0)[:, None], rho, 0).to(torch.int32)
        cols = torch.arange(X.shape[1], dtype=torch.int64, device=X.device)[None, :]
        idx = (cols * m + bucket).reshape(-1)
        acc["regs"].view(-1).scatter_reduce_(0, idx, rho.reshape(-1), "amax")
        return acc

    return step, None


def _hll_finalize(acc: Dict[str, Any], ctx: Dict[str, Any]):
    from .sketches import hll_estimate

    return {"distinct": hll_estimate(np.asarray(acc["regs"]))}


register_program(StatProgram(
    name="distinct_count",
    kind="device",
    shapes=_hll_shapes,
    init=_hll_init,
    make_step=_hll_make_step,
    finalize=_hll_finalize,
    doc="per-column HyperLogLog approximate distinct counts",
    resolve=lambda opts: dict(opts, bits=_hll_bits(opts)),
))


# ---------------------------------------------------------------------------
# host sketch programs: KLL-style quantiles, Misra-Gries frequent items
# ---------------------------------------------------------------------------


def _qk(opts: Dict[str, Any]) -> int:
    return int(opts.get("k") or get_config("summarizer_sketch_k"))


def _quantile_shapes(d: int, opts: Dict[str, Any]) -> Dict[str, Field]:
    from .sketches import QUANTILE_LEVELS

    k = _qk(opts)
    return {"items": Field((d, QUANTILE_LEVELS, k), "float64", merge="slot"),
            "sizes": Field((QUANTILE_LEVELS,), "int64", merge="slot"),
            "n": Field((), "int64")}


def _quantile_init(d: int, dtype, opts: Dict[str, Any], device=None):
    from .sketches import quantile_init

    return quantile_init(d, _qk(opts))


def _quantile_make_step(d: int, dtype, opts: Dict[str, Any]):
    from .sketches import quantile_update

    k = _qk(opts)

    def step(acc, X, w, y, ctx):
        return quantile_update(acc, X, np.asarray(w) > 0, k)

    return step


def _quantile_merge(a, b, opts: Dict[str, Any]):
    from .sketches import quantile_merge

    return quantile_merge(a, b, _qk(opts))


def _quantile_finalize(acc: Dict[str, Any], ctx: Dict[str, Any]):
    from .sketches import quantile_query

    qs = ctx.get("quantiles") or (0.25, 0.5, 0.75)
    vals = quantile_query(acc, qs)
    return {"n": int(acc["n"]), "quantiles": {float(q): vals[:, i] for i, q in enumerate(qs)},
            "state": acc}


register_program(StatProgram(
    name="quantile_sketch",
    kind="host",
    shapes=_quantile_shapes,
    init=_quantile_init,
    make_step=_quantile_make_step,
    finalize=_quantile_finalize,
    merge=_quantile_merge,
    doc="mergeable KLL-style per-column quantile sketch",
    resolve=lambda opts: dict(opts, k=_qk(opts)),
))


def _fk(opts: Dict[str, Any]) -> int:
    return int(opts.get("cap") or get_config("summarizer_frequent_k"))


def _frequent_shapes(d: int, opts: Dict[str, Any]) -> Dict[str, Field]:
    cap = _fk(opts)
    return {"keys": Field((d, cap), "float64", merge="slot"),
            "counts": Field((d, cap), "int64", merge="slot"),
            "err": Field((d,), "int64"),
            "n": Field((), "int64")}


def _frequent_init(d: int, dtype, opts: Dict[str, Any], device=None):
    from .sketches import frequent_init

    return frequent_init(d, _fk(opts))


def _frequent_make_step(d: int, dtype, opts: Dict[str, Any]):
    from .sketches import frequent_update

    cap = _fk(opts)

    def step(acc, X, w, y, ctx):
        return frequent_update(acc, X, np.asarray(w) > 0, cap)

    return step


def _frequent_merge(a, b, opts: Dict[str, Any]):
    from .sketches import frequent_merge

    return frequent_merge(a, b, _fk(opts))


def _frequent_finalize(acc: Dict[str, Any], ctx: Dict[str, Any]):
    from .sketches import frequent_items_result

    return {"n": int(acc["n"]), "items": frequent_items_result(acc),
            "error_bound": np.asarray(acc["err"]), "state": acc}


register_program(StatProgram(
    name="frequent_items",
    kind="host",
    shapes=_frequent_shapes,
    init=_frequent_init,
    make_step=_frequent_make_step,
    finalize=_frequent_finalize,
    merge=_frequent_merge,
    doc="Misra-Gries per-column frequent items (count lower bounds with a declared error "
        "slack)",
    resolve=lambda opts: dict(opts, cap=_fk(opts)),
))


# ---------------------------------------------------------------------------
# the seeding sample of the streamed k-means: a strided global subsample,
# each row written to the slot of its global row, so any chunk order or
# split assembles the same sample
# ---------------------------------------------------------------------------


def _ks_opts(opts: Dict[str, Any]) -> Tuple[int, int]:
    return int(opts.get("stride", 1)), int(opts.get("cap", 8))


def _kmeans_sample_shapes(d: int, opts: Dict[str, Any]) -> Dict[str, Field]:
    _, cap = _ks_opts(opts)
    return {"rows": Field((cap, d), "float64", merge="slot"),
            "w": Field((cap,), "float64", merge="slot"),
            "mask": Field((cap,), "int64", merge="slot")}


def _kmeans_sample_init(d: int, dtype, opts: Dict[str, Any], device=None):
    _, cap = _ks_opts(opts)
    return {"rows": np.zeros((cap, d), np.float64), "w": np.zeros((cap,), np.float64),
            "mask": np.zeros((cap,), np.int64)}


def _kmeans_sample_make_step(d: int, dtype, opts: Dict[str, Any]):
    stride, cap = _ks_opts(opts)

    def step(acc, X, w, y, ctx):
        offset = int(ctx["offset"])
        n_c = int(ctx["n_valid"])
        gidx = np.arange(offset, offset + n_c)
        pick = (gidx % stride) == 0
        if pick.any():
            slots = gidx[pick] // stride
            slots = slots[slots < cap]
            pick = np.flatnonzero(pick)[: slots.size]
            acc["rows"][slots] = np.asarray(X[:n_c][pick], np.float64)
            acc["w"][slots] = np.asarray(w[:n_c][pick], np.float64)
            acc["mask"][slots] = 1
        return acc

    return step


def _kmeans_sample_merge(a, b, opts: Dict[str, Any]):
    take = np.asarray(b["mask"]) > 0
    out = {k: np.array(v) for k, v in a.items()}
    out["rows"][take] = np.asarray(b["rows"])[take]
    out["w"][take] = np.asarray(b["w"])[take]
    out["mask"][take] = 1
    return out


def _kmeans_sample_finalize(acc: Dict[str, Any], ctx: Dict[str, Any]):
    filled = np.asarray(acc["mask"]) > 0
    return {"X": np.asarray(acc["rows"])[filled], "w": np.asarray(acc["w"])[filled],
            "count": int(filled.sum())}


register_program(StatProgram(
    name="kmeans_sample",
    kind="host",
    shapes=_kmeans_sample_shapes,
    init=_kmeans_sample_init,
    make_step=_kmeans_sample_make_step,
    finalize=_kmeans_sample_finalize,
    merge=_kmeans_sample_merge,
    doc="strided global row subsample feeding the seeded k-means|| init (slot-disjoint: any "
        "chunking assembles the identical sample)",
    opts_defaults={"stride": 1, "cap": 8},
))
