#
# Exact k-NN on one device: the port of the single-device part of
# spark_rapids_ml_tpu/ops/knn.py.
#
#   knn_topk_single     the dispatch: the fused kernel (ops/fused_knn.py)
#                       unless `pallas_knn` is "off", then the plain forms;
#   knn_topk_blocked    plain torch, queries in blocks, one (block, n)
#                       distance tile at a time;
#   knn_topk_coltiled   plain torch, both axes in blocks, each tile folded
#                       into a running (block, k) top-k;
#   smallest_k          the k smallest distances of each row in
#                       `lax.top_k`'s order, for IVF and CAGRA.
#
# The JAX package's `pallas_knn` default is "off" and its "auto" runs a
# measured probe, both because its Pallas kernel lost to XLA on the TPU.
# The port's default is "on", "auto" means "on", and no probe is ported:
# on the card the hand-written kernel is the kNN path.  "off" is the
# user's explicit choice of the plain forms.  The ring over several
# devices (`knn_ring_topk`) waits for the multi-GPU work in ROADMAP.md.
#
# All three order ties by the lowest item position, as `lax.top_k` and the
# TPU kernel do.  Returned ids are `item_ids` values, -1 for slots past the
# valid count.
#
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..config import get_config
from .distances import sqdist
from .fused_knn import knn_topk_fused, route

# query rows per block of the plain forms
_QUERY_BLOCK = 1024
# the blocked form's (block, n) distance tile may take this many bytes;
# past it the dispatch takes the double-tiled form
_BLOCKED_TILE_LIMIT_BYTES = 2 << 30

# Which form the last `knn_topk_single` ran ("kernel") and why
# ("decided_by": "forced" for pallas_knn="on" or "auto", "config" for
# "off").  The fused kernel on a CUDA tensor reads the main kernel that ran
# (fused_knn.py `route`): "fused_knn_smallq" (float32, few queries, k <= 32),
# "fused_knn_tf32" (other float32) or "fused_knn_f64" (float64), the kernels
# of csrc/fused_knn.cu; on a CPU tensor the wrapper runs its twin,
# "fused_topk_sqdist_reference".
LAST_KERNEL_DECISION: Dict[str, Optional[str]] = {"kernel": None, "decided_by": None}

_MODES = ("on", "auto", "off")


def _merge_topk(run_d, run_i, blk_d, blk_i, k: int):
    """Fold a (q, m) distance block into the running (q, k) top-k state;
    a stable sort keeps the earlier (lower-position) entry of a tie."""
    cat_d = torch.cat([run_d, blk_d], dim=1)
    cat_i = torch.cat([run_i, blk_i.expand(blk_d.shape[0], -1)], dim=1)
    srt, order = torch.sort(cat_d, dim=1, stable=True)
    return srt[:, :k], torch.gather(cat_i, 1, order[:, :k])


def smallest_k(values: torch.Tensor, k: int):
    """(values, positions) of the k smallest entries of each row, ascending,
    ties to the lower position: `lax.top_k(-values, k)`.  `values` are
    distances: non-negative or +inf.  In float32 one int64 key per entry,
    the value's bits above the position, makes every entry distinct, so
    `torch.topk` (which promises no order among equal values) returns that
    exact order (the bits of non-negative floats order as the floats do);
    other dtypes take a stable sort."""
    width = values.shape[-1]
    if values.dtype != torch.float32 or width >= 2**31:
        srt, pos = torch.sort(values, dim=-1, stable=True)
        return srt[..., :k], pos[..., :k]
    pb = max(1, width - 1).bit_length()
    # the sign bit off: -0.0 ranks as +0.0, as the comparison does
    bits = (values.view(torch.int32) & 0x7FFFFFFF).to(torch.int64)
    pos = torch.arange(width, dtype=torch.int64, device=values.device)
    keys = torch.topk((bits << pb) | pos, k, dim=-1, largest=False, sorted=True).values
    pos = keys & ((1 << pb) - 1)
    return torch.gather(values, -1, pos), pos


def knn_topk_blocked(items, item_valid, item_ids, queries, k: int,
                     block: int = _QUERY_BLOCK):
    """Brute force with the query axis tiled: peak memory is one (block, n)
    distance tile."""
    q = queries.shape[0]
    block = max(1, min(block, q))
    valid = item_valid > 0
    masked_ids = torch.where(valid, item_ids, -1)
    out_d = torch.empty((q, k), dtype=queries.dtype, device=queries.device)
    out_i = torch.empty((q, k), dtype=item_ids.dtype, device=queries.device)
    for q0 in range(0, q, block):
        d2 = sqdist(queries[q0 : q0 + block], items)
        d2 = torch.where(valid[None, :], d2, float("inf"))
        srt, pos = torch.sort(d2, dim=1, stable=True)
        out_d[q0 : q0 + block] = srt[:, :k]
        out_i[q0 : q0 + block] = masked_ids[pos[:, :k]]
    return out_d, out_i


def knn_topk_coltiled(items, item_valid, item_ids, queries, k: int,
                      block: int = _QUERY_BLOCK, cblock: int = 8192):
    """Brute force with both axes tiled: each (block, cblock) distance tile
    folds into a running (block, k) top-k.  Exact-equivalent to
    `knn_topk_blocked`."""
    q = queries.shape[0]
    n = items.shape[0]
    block = max(1, min(block, q))
    cb = max(1, min(cblock, n))
    valid = item_valid > 0
    masked_ids = torch.where(valid, item_ids, -1)
    out_d = torch.empty((q, k), dtype=queries.dtype, device=queries.device)
    out_i = torch.empty((q, k), dtype=item_ids.dtype, device=queries.device)
    for q0 in range(0, q, block):
        Qb = queries[q0 : q0 + block]
        run_d = torch.full((Qb.shape[0], k), float("inf"), dtype=queries.dtype,
                           device=queries.device)
        run_i = torch.full((Qb.shape[0], k), -1, dtype=item_ids.dtype,
                           device=queries.device)
        for n0 in range(0, n, cb):
            d2 = sqdist(Qb, items[n0 : n0 + cb])
            d2 = torch.where(valid[None, n0 : n0 + cb], d2, float("inf"))
            run_d, run_i = _merge_topk(run_d, run_i, d2,
                                       masked_ids[None, n0 : n0 + cb], k)
        out_d[q0 : q0 + block] = run_d
        out_i[q0 : q0 + block] = run_i
    return out_d, out_i


def knn_topk_single(items, item_valid, item_ids, queries, k: int):
    """Single-device brute force: (squared distances (q, k), ids (q, k)).
    The fused kernel unless `pallas_knn` is "off"; then the blocked form
    while one (block, n) tile fits `_BLOCKED_TILE_LIMIT_BYTES`, else the
    double-tiled form."""
    mode = str(get_config("pallas_knn")).lower()
    if mode not in _MODES:
        raise ValueError(f"pallas_knn must be one of {sorted(_MODES)}, got {mode!r}")
    if mode != "off":  # "auto" is "on"
        kernel = "fused_topk_sqdist_reference"
        if queries.is_cuda:
            kernel = route(int(queries.shape[0]), k, queries.dtype)
        LAST_KERNEL_DECISION.update(kernel=kernel, decided_by="forced")
        return knn_topk_fused(items, item_valid, item_ids, queries, k)
    qb = min(_QUERY_BLOCK, max(int(queries.shape[0]), 1))
    tile_bytes = qb * int(items.shape[0]) * queries.element_size()
    if tile_bytes > _BLOCKED_TILE_LIMIT_BYTES:
        LAST_KERNEL_DECISION.update(kernel="knn_topk_coltiled", decided_by="config")
        return knn_topk_coltiled(items, item_valid, item_ids, queries, k)
    LAST_KERNEL_DECISION.update(kernel="knn_topk_blocked", decided_by="config")
    return knn_topk_blocked(items, item_valid, item_ids, queries, k)
