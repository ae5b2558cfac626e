#
# Host-driven L-BFGS / OWL-QN: the port of `lbfgs_minimize_host` in
# spark_rapids_ml_tpu/ops/lbfgs.py.  The optimizer state lives in numpy in
# float64 and every function evaluation is one call of the oracle, which
# runs on the device (ops/logistic.py); the solver sees only (f, g) on the
# host.  The two-loop recursion, the Armijo displacement line search, the
# orthant projection, the convergence tests and the objective history are
# the JAX package's, operation for operation: given the same oracle, the
# iterates are equal bit for bit.  Its resilience seams are the JAX
# function's too: the `lbfgs_iteration` fault site at the top of every
# iteration, and with `checkpoint_path` the whole optimizer state (w, f, g,
# the S / Y history, rho, k, it, the objective history, converged) saved
# after every iteration in the JAX package's layout, so that a fit killed at
# iteration k resumes at k on the same trajectory, in either package.  The
# heartbeat waits for the telemetry item.
#
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np


def lbfgs_minimize_host(
    value_and_grad: Callable[[np.ndarray], Tuple[float, np.ndarray]],
    w0: np.ndarray,
    max_iter: int = 100,
    tol: float = 1e-6,
    history: int = 10,
    l1: float = 0.0,
    l1_mask: Optional[np.ndarray] = None,
    ls_max: int = 20,
    checkpoint_path: Optional[str] = None,
    checkpoint_tag: str = "",
) -> Tuple[np.ndarray, int, bool, List[float]]:
    """Minimize f(w) + l1 * ||w * l1_mask||_1 with L-BFGS (OWL-QN when
    l1 > 0).  `value_and_grad(w)` returns (f_smooth, grad) for a float64
    (n,) w; the L2 term belongs inside f.  With `checkpoint_path` the state
    is saved under `checkpoint_tag` after every iteration, a saved state of
    the same tag is resumed, and the file is removed at the end.

    Returns (w, n_iter, converged, history), history the full
    (penalty-inclusive) objective per accepted iterate, entry 0 = initial."""
    from ..resilience import faults, metrics
    from ..resilience.checkpoint import clear_checkpoint, load_checkpoint, save_checkpoint

    n = w0.shape[0]
    m = history
    l1 = float(l1)
    if l1_mask is None:
        l1_mask = np.ones((n,), np.float64)

    def full_term(w):
        return (l1 * l1_mask * np.abs(w)).sum()

    def pseudo_grad(w, g):
        l1v = l1 * l1_mask
        gp, gm = g + l1v, g - l1v
        return np.where(
            w > 0,
            gp,
            np.where(w < 0, gm, np.where(gm > 0, gm, np.where(gp < 0, gp, 0.0))),
        )

    S = np.zeros((m, n))
    Y = np.zeros((m, n))
    rho = np.zeros((m,))
    k = 0
    resumed = load_checkpoint(checkpoint_path, checkpoint_tag) if checkpoint_path else None

    def direction(pg):
        q = pg.astype(np.float64).copy()
        alpha = np.zeros((m,))
        kk = min(k, m)
        for j in range(kk):
            idx = (k - 1 - j) % m
            a = rho[idx] * (S[idx] @ q)
            q -= a * Y[idx]
            alpha[idx] = a
        if k > 0:
            newest = (k - 1) % m
            sy = S[newest] @ Y[newest]
            yy = Y[newest] @ Y[newest]
            gamma = sy / max(yy, 1e-30)
        else:
            gamma = 1.0
        r = gamma * q
        for j in range(m - kk, m):
            idx = (k - m + j) % m
            b = rho[idx] * (Y[idx] @ r)
            r += (alpha[idx] - b) * S[idx]
        return -r

    if resumed is not None:
        w = np.asarray(resumed["w"])
        f = float(resumed["f"])
        g = np.asarray(resumed["g"])
        S[:] = resumed["S"]
        Y[:] = resumed["Y"]
        rho[:] = resumed["rho"]
        k = int(resumed["k"])
        it = int(resumed["it"])
        hist = [float(v) for v in resumed["hist"]]
        converged = bool(resumed["converged"])
        metrics.event("lbfgs_resume", detail=f"it={it}")
    else:
        w = np.asarray(w0, np.float64).copy()
        f, g = value_and_grad(w)
        hist = [float(f + full_term(w))]
        converged = False
        it = 0
    pg = None  # the pseudo-gradient at w, carried from the iteration before
    while it < max_iter and not converged:
        faults.maybe_inject("lbfgs_iteration")
        if pg is None:
            pg = pseudo_grad(w, g)
        p = direction(pg)
        if l1 > 0:
            p = np.where(p * (-pg) > 0, p, 0.0)
        xi = np.where(w != 0, np.sign(w), np.sign(-pg))

        def project(w_t):
            return np.where(w_t * xi >= 0, w_t, 0.0) if l1 > 0 else w_t

        t = 1.0 if k > 0 else 1.0 / max(np.linalg.norm(p), 1.0)
        fw_full = hist[-1]
        w_new, f_new, g_new = w, f, g
        for _ in range(ls_max + 1):
            w_t = project(w + t * p)
            f_t, g_t = value_and_grad(w_t)
            w_new, f_new, g_new = w_t, f_t, g_t
            if f_t + full_term(w_t) <= fw_full + 1e-4 * (pg @ (w_t - w)):
                break
            t *= 0.5

        s = w_new - w
        yv = g_new - g
        sy = s @ yv
        if sy > 1e-10:
            idx = k % m
            S[idx], Y[idx], rho[idx] = s, yv, 1.0 / max(sy, 1e-30)
            k += 1

        new_full = float(f_new + full_term(w_new))
        old_full = hist[-1]
        rel_impr = (old_full - new_full) / max(abs(old_full), 1e-30)
        pg_new = pseudo_grad(w_new, g_new)
        gnorm = np.linalg.norm(pg_new)
        converged = bool(
            gnorm <= tol * max(1.0, np.linalg.norm(w_new))
            or abs(rel_impr) <= tol
        )
        w, f, g, pg = w_new, f_new, g_new, pg_new
        hist.append(new_full)
        it += 1
        if checkpoint_path:
            save_checkpoint(checkpoint_path, checkpoint_tag, {
                "w": w, "f": f, "g": g, "S": S, "Y": Y,
                "rho": rho, "k": k, "it": it,
                "hist": np.asarray(hist), "converged": converged,
            })
    if checkpoint_path:
        clear_checkpoint(checkpoint_path)
    return w, it, converged, hist
