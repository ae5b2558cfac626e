#
# Logistic regression on the device: the port of spark_rapids_ml_tpu/
# ops/logistic.py, dense rows and sparse rows in ELL form (ops/sparse.py).
#
# Spark objective (as in the JAX package): 1/sum(w) * sum_i w_i *
# logloss(x_i, y_i) + regParam * [alpha ||beta||_1 + (1 - alpha)/2 ||beta||^2],
# intercepts unpenalized.  Binomial is Spark's single coefficient vector
# (margin x.beta + b); multinomial is the softmax over C coefficient rows.
#
# The JAX package differentiates the loss with `jax.value_and_grad`; the
# port writes the gradient in closed form, so an evaluation builds no
# autograd graph over N rows and makes no N x d temporary:
#   binomial     g_beta = X^T (w * (sigmoid(m) - y)) / sum(w) + l2 beta
#   multinomial  g_W    = (w * (softmax - onehot))^T X / sum(w) + l2 W
# with sigmoid(m) - y taken as -s * sigmoid(-s m), s = 2y - 1, exact for
# large |m|.  An evaluation is two matrix-vector products over X (margins,
# then gradient) and elementwise work on N-vectors (N x C for
# multinomial).  The matmuls run in IEEE float32 (ops/precision.py
# `ieee_matmul`), never TF32.
#
# ELL rows (`EllOracle`): the margins gather the coefficients of each
# row's columns (ops/sparse.py `ell_matvec` / `ell_matmat`) and the
# gradient sums value * residual per column over the column-sorted entries
# (`ell_rmatvec` / `ell_rmatmat`): no atomics, so two evaluations of the
# same theta are bit-equal on a card too.  Its arithmetic is float64
# whatever the rows' type (float32 rows stay float32 in memory and are
# widened as they are read), and the standardization scales the
# coefficients, not the rows: any float32 rounding moves the L-BFGS
# trajectory, and on slowly converging fits the relative-improvement test
# then stops at another iteration.  On 1,000,000 Criteo-layout rows x 2^18
# with 5 classes a float32 oracle stopped at 43 iterations, 2.4e-5 above
# the float64 fit's 54 (an H100; PERF.md).  So a fit of float32 rows is
# the float64 fit of the same values, iterate for iterate.
#
# The solver always runs host-driven (`logreg_fit_host_dispatch`: one device
# evaluation and one device-to-host fetch of (f, g) per oracle call, the
# optimizer in numpy float64, ops/lbfgs.py).  The JAX package also has a
# single-program while_loop solver for fits under its `dispatch_flops_limit`;
# the port has no counterpart, so its float32 iterates follow the
# host-driven path at every size.
#
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .precision import ieee_matmul

# Sample-weight contract: the loss, gradient, label range and the
# standardization moments weight rows by `w` and normalise by sum(w), so a
# row of weight 0 is absent from the optimisation whatever its features and
# label.
SUPPORTS_ZERO_WEIGHT_ROWS = True

# Oracle evaluations made by `LogisticOracle.__call__` since the last reset
# (chip_smoke.py resets it before a fit and reads it after).
ORACLE_CALLS = 0


def _theta_layout(C: int, d: int, fit_intercept: bool):
    """The packed-theta layout, coefficients first, then intercepts; C = 1
    is the binomial single-beta family.  Returns (n_coef, n_param, l1_mask
    (float64 numpy, 0 on intercepts), unpack), where unpack(theta) gives
    (beta (d,), b ()) for C = 1 and (W (C, d), b (C,)) otherwise, for a
    torch tensor or a numpy array."""
    n_coef = C * d
    n_param = n_coef + (C if fit_intercept else 0)

    def unpack(theta):
        zeros = (theta.new_zeros if isinstance(theta, torch.Tensor)
                 else lambda shape: np.zeros(shape, theta.dtype))
        if C == 1:
            return theta[:d], (theta[d] if fit_intercept else zeros(()))
        return (theta[:n_coef].reshape(C, d),
                theta[n_coef:] if fit_intercept else zeros((C,)))

    l1_mask = np.concatenate([np.ones(n_coef), np.zeros(n_param - n_coef)])
    return n_coef, n_param, l1_mask, unpack


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(x)), exact for every x (torch.nn.functional.softplus
    returns x itself above its threshold)."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-torch.abs(x)))


class LogisticOracle:
    """Value and gradient of the Spark logistic objective over
    device-resident rows: X (N, d), w (N,) validity * sample weights, y (N,)
    integer labels.  Called with a float64 numpy theta, it evaluates on X's
    device in X's type and returns (f, g) on the host, f a float and g
    float64, in one device-to-host copy.  Its parts (`margins`,
    `loss_and_residual`, `gradient`) are public so they can be timed one by
    one.  `wsum` is the weight the loss is normalised by, sum(w) unless
    given (a chunk of a streamed fit gives the whole file's); `dtype` the
    arithmetic's type, X's unless given."""

    def __init__(self, X: torch.Tensor, w: torch.Tensor, y: torch.Tensor,
                 n_classes: int, l2: float, fit_intercept: bool,
                 binomial: bool, wsum: Optional[float] = None,
                 d: Optional[int] = None, dtype: Optional[torch.dtype] = None) -> None:
        self.X = X
        self.dtype = X.dtype if dtype is None else dtype
        self.l2 = float(l2)
        self.fit_intercept = fit_intercept
        self.binomial = binomial
        self.C = 1 if binomial else int(n_classes)
        self.n_coef, self.n_param, self.l1_mask, self.unpack = _theta_layout(
            self.C, X.shape[1] if d is None else int(d), fit_intercept)
        w = w.to(self.dtype)
        self.w_scaled = w / (w.sum() if wsum is None else wsum)
        if binomial:
            self.sgn = 2.0 * y.to(self.dtype) - 1.0  # {-1, +1}
        else:
            # a row of weight 0 may carry any label: clamp it into range
            self.labels = y.long().clamp(0, self.C - 1).unsqueeze(1)

    def margins(self, theta: torch.Tensor) -> torch.Tensor:
        """x.beta + b (N,) for binomial, X W^T + b (N, C) otherwise."""
        coef, b = self.unpack(theta)
        with ieee_matmul():
            m = self.X @ (coef if self.binomial else coef.T)
        m += b
        return m

    def loss_and_residual(self, m: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(data loss (), residual r) where the data gradient is r^T X and,
        for the intercepts, the sum of r over rows."""
        if self.binomial:
            z = -self.sgn * m
            loss = (softplus(z) * self.w_scaled).sum()
            r = torch.sigmoid(z)
            r *= -self.sgn
            r *= self.w_scaled
            return loss, r
        logp = torch.log_softmax(m, dim=1)
        loss = -(logp.gather(1, self.labels).squeeze(1) * self.w_scaled).sum()
        r = torch.exp(logp)
        r.scatter_add_(1, self.labels, torch.full_like(r[:, :1], -1.0))
        r *= self.w_scaled.unsqueeze(1)
        return loss, r

    def gradient(self, r: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(r^T X, sum of r over rows): the data gradient of the
        coefficients and of the intercepts."""
        with ieee_matmul():
            g_coef = r @ self.X if self.binomial else r.T @ self.X
        return g_coef, r.sum(dim=0)

    def value_and_grad(self, theta: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(f, g) on the device for a theta on the device."""
        coef, _ = self.unpack(theta)
        loss, r = self.loss_and_residual(self.margins(theta))
        g_coef, g_b = self.gradient(r)
        f = loss + 0.5 * self.l2 * (coef * coef).sum()
        g_coef = g_coef + self.l2 * coef
        parts = [g_coef.reshape(-1)] + ([g_b.reshape(-1)] if self.fit_intercept else [])
        return f, torch.cat(parts)

    def __call__(self, theta: np.ndarray) -> Tuple[float, np.ndarray]:
        global ORACLE_CALLS
        ORACLE_CALLS += 1
        f, g = self.value_and_grad(
            torch.as_tensor(theta, dtype=self.dtype, device=self.X.device))
        host = torch.cat([f.reshape(1), g]).cpu().numpy()  # one D2H copy
        return float(host[0]), host[1:].astype(np.float64)


class EllOracle(LogisticOracle):
    """`LogisticOracle` over ELL rows: `vals`, `cols` (N, K) and d
    columns, evaluated in float64 (see the head of this file).  The
    column-sorted layout of the entries (ops/sparse.py
    `ell_column_layout`) is built here unless given, and the sorted values
    gathered once.  `inv_std` (d,) standardizes in the coefficients' space:
    the margins take coef * inv_std and the gradient is scaled back, so the
    stored values stay the input's, whatever their type."""

    def __init__(self, vals: torch.Tensor, cols: torch.Tensor, w: torch.Tensor,
                 y: torch.Tensor, n_classes: int, l2: float, fit_intercept: bool,
                 binomial: bool, d: int, layout=None, wsum: Optional[float] = None,
                 inv_std: Optional[torch.Tensor] = None) -> None:
        from .sparse import ell_column_layout

        super().__init__(vals, w, y, n_classes, l2, fit_intercept, binomial, wsum=wsum, d=d,
                         dtype=torch.float64)
        self.cols = cols
        self.inv_std = None if inv_std is None else inv_std.to(torch.float64)
        self.layout = layout if layout is not None else ell_column_layout(vals, cols, d)
        self.sorted_vals = self.layout.gather(vals)

    def margins(self, theta: torch.Tensor) -> torch.Tensor:
        from .sparse import ell_matmat, ell_matvec

        coef, b = self.unpack(theta)
        if self.inv_std is not None:
            coef = coef * self.inv_std
        m = (ell_matvec(self.X, self.cols, coef) if self.binomial
             else ell_matmat(self.X, self.cols, coef))
        m += b
        return m

    def gradient(self, r: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        from .sparse import ell_rmatmat, ell_rmatvec

        g_coef = (ell_rmatvec(self.layout, self.sorted_vals, r) if self.binomial
                  else ell_rmatmat(self.layout, self.sorted_vals, r))
        if self.inv_std is not None:
            g_coef = g_coef * self.inv_std
        return g_coef, r.sum(dim=0)


def logreg_fit_host_dispatch(
    X: torch.Tensor,
    w: torch.Tensor,
    y: torch.Tensor,
    n_classes: int,
    l2: float,
    l1: float,
    fit_intercept: bool = True,
    tol: float = 1e-6,
    max_iter: int = 100,
    history: int = 10,
    ls_max: int = 20,
    binomial: bool = False,
    cols: Optional[torch.Tensor] = None,
    d: Optional[int] = None,
    layout=None,
    inv_std: Optional[torch.Tensor] = None,
    checkpoint_path: Optional[str] = None,
    checkpoint_tag: str = "",
):
    """Host-driven L-BFGS/OWL-QN over device-resident rows: the optimizer
    state lives on the host in float64 and each oracle call is one device
    evaluation and one fetch of (f, g).  With `cols`, X holds ELL values
    (`EllOracle`, d columns, `layout` its column-sorted entries if already
    built, `inv_std` its standardization).  `checkpoint_path` / `checkpoint_tag` go to
    `lbfgs_minimize_host`: the state is saved after every iteration and a
    later call with the same tag resumes it.

    Returns (W (C, d) | coef (d,), b, loss, n_iter, history) as numpy in
    the oracle's type (X's; float64 for ELL rows) (history: the full objective per iteration, entry 0 the
    initial one), the shapes of the JAX function for the same `binomial`."""
    from .lbfgs import lbfgs_minimize_host

    if cols is None:
        oracle = LogisticOracle(X, w, y, n_classes, l2, fit_intercept, binomial)
    else:
        oracle = EllOracle(X, cols, w, y, n_classes, l2, fit_intercept, binomial,
                           d=int(d), layout=layout, inv_std=inv_std)
    theta, n_iter, _, hist = lbfgs_minimize_host(
        oracle,
        np.zeros((oracle.n_param,), np.float64),
        max_iter=max_iter,
        tol=tol,
        history=history,
        l1=l1,
        l1_mask=oracle.l1_mask,
        ls_max=ls_max,
        checkpoint_path=checkpoint_path,
        checkpoint_tag=checkpoint_tag,
    )
    from ..parallel.mesh import _numpy_dtype

    dtype = _numpy_dtype(oracle.dtype)
    coef, b = oracle.unpack(theta.astype(dtype))
    return coef, b, hist[-1], n_iter, np.asarray(hist, dtype)


def logreg_fit_binary_ell(vals: torch.Tensor, cols: torch.Tensor, w: torch.Tensor,
                          y: torch.Tensor, l2: float, l1: float, d: int, **kwargs):
    """Binary logistic regression over ELL rows (the JAX function of the
    same name; here host-driven, as every port fit)."""
    return logreg_fit_host_dispatch(vals, w, y, n_classes=2, l2=l2, l1=l1, binomial=True,
                                    cols=cols, d=d, **kwargs)


def logreg_fit_ell(vals: torch.Tensor, cols: torch.Tensor, w: torch.Tensor, y: torch.Tensor,
                   n_classes: int, l2: float, l1: float, d: int, **kwargs):
    """Multinomial logistic regression over ELL rows."""
    return logreg_fit_host_dispatch(vals, w, y, n_classes=n_classes, l2=l2, l1=l1,
                                    binomial=False, cols=cols, d=d, **kwargs)


def logreg_predict(X: torch.Tensor, W: torch.Tensor, b: torch.Tensor):
    """(prediction int32 (N,), probability (N, C), rawPrediction (N, C))."""
    with ieee_matmul():
        logits = X @ W.T
    logits += b
    return torch.argmax(logits, dim=1).to(torch.int32), torch.softmax(logits, dim=1), logits


def binary_predict(X: torch.Tensor, coef: torch.Tensor, intercept: torch.Tensor):
    """Spark binomial form: margin m = x.beta + b, raw = [-m, m],
    prob = [1 - sigmoid(m), sigmoid(m)]."""
    with ieee_matmul():
        margin = X @ coef
    margin += intercept
    p1 = torch.sigmoid(margin)
    raw = torch.stack([-margin, margin], dim=1)
    probs = torch.stack([1.0 - p1, p1], dim=1)
    return (margin > 0).to(torch.int32), probs, raw

