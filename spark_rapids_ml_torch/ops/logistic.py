#
# Logistic regression on the device: the port of the dense route of
# spark_rapids_ml_tpu/ops/logistic.py.
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
    given (a chunk of a streamed fit gives the whole file's)."""

    def __init__(self, X: torch.Tensor, w: torch.Tensor, y: torch.Tensor,
                 n_classes: int, l2: float, fit_intercept: bool,
                 binomial: bool, wsum: Optional[float] = None) -> None:
        self.X = X
        self.dtype = X.dtype
        self.l2 = float(l2)
        self.fit_intercept = fit_intercept
        self.binomial = binomial
        self.C = 1 if binomial else int(n_classes)
        self.n_coef, self.n_param, self.l1_mask, self.unpack = _theta_layout(
            self.C, X.shape[1], fit_intercept)
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
):
    """Host-driven L-BFGS/OWL-QN over device-resident rows: the optimizer
    state lives on the host in float64 and each oracle call is one device
    evaluation and one fetch of (f, g).

    Returns (W (C, d) | coef (d,), b, loss, n_iter, history) as numpy in
    X's type (history: the full objective per iteration, entry 0 the
    initial one), the shapes of the JAX function for the same `binomial`."""
    from .lbfgs import lbfgs_minimize_host

    oracle = LogisticOracle(X, w, y, n_classes, l2, fit_intercept, binomial)
    theta, n_iter, _, hist = lbfgs_minimize_host(
        oracle,
        np.zeros((oracle.n_param,), np.float64),
        max_iter=max_iter,
        tol=tol,
        history=history,
        l1=l1,
        l1_mask=oracle.l1_mask,
        ls_max=ls_max,
    )
    from ..parallel.mesh import _numpy_dtype

    dtype = _numpy_dtype(X.dtype)
    coef, b = oracle.unpack(theta.astype(dtype))
    return coef, b, hist[-1], n_iter, np.asarray(hist, dtype)


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

