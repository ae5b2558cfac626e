#
# Fused distance + top-k for exact kNN: the port of
# spark_rapids_ml_tpu/ops/pallas_knn.py.
#
#   fused_topk_sqdist            the kernel's wrapper.  On a CUDA tensor it
#                                launches the hand-written kernel
#                                (csrc/fused_knn.cu) or raises; on a CPU
#                                tensor it runs the plain twin below.
#   fused_topk_sqdist_reference  the plain PyTorch twin: the TPU kernel's
#                                tile and merge semantics in torch ops.
#   knn_topk_fused               the wrapper plus the position -> id map.
#
# The kernel has no width bound and no dtype branch: it stages rows through
# shared memory in chunks along d, and it is templated on float32 and
# float64, so `float32_inputs=False` keeps float64 inside the kernel (the
# JAX package sends float64 to XLA instead, and bounds d at 4096).
#
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .precision import matmul_precision

_SOURCE = "fused_knn.cu"
# stand-in for +inf inside the twin's running state, as in the TPU kernel
_BIG = 3.0e38
_INT32_MAX = 2**31 - 1

# Launches of the CUDA kernel since the last reset (chip_smoke.py resets it
# before the main path and reads it after).  The twin never counts.
LAUNCHES = 0


def item_norms(items: torch.Tensor, item_valid: torch.Tensor) -> torch.Tensor:
    """||x||^2 per item, zeroed where the item is invalid."""
    return (items * items).sum(dim=1) * (item_valid > 0).to(items.dtype)


def fused_topk_sqdist_reference(
    items: torch.Tensor,  # (n, d)
    item_valid: torch.Tensor,  # (n,) > 0 for a real item
    queries: torch.Tensor,  # (q, d)
    k: int,
    bq: int = 256,
    bn: int = 512,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of the fused kernel: (squared distances (q, k),
    int32 item POSITIONS (q, k)), best first.

    Query rows go in blocks of `bq`; items in tiles of `bn`.  Each tile's
    score ||x||^2 - 2 q.x (+BIG where invalid) joins the running (bq, k)
    state, and a stable sort keeps the k least, so ties go to the lowest
    position exactly as the TPU kernel's first-argmin does.  Then
    d^2 = max(score + ||q||^2, 0), with +inf and -1 past the valid count."""
    q, _ = queries.shape
    n = items.shape[0]
    dev, dt = queries.device, queries.dtype
    x2 = item_norms(items, item_valid)
    valid = item_valid > 0
    out_d = torch.empty((q, k), dtype=dt, device=dev)
    out_i = torch.empty((q, k), dtype=torch.int32, device=dev)
    bq = min(bq, max(8, q))
    for q0 in range(0, q, bq):
        Qb = queries[q0 : q0 + bq]
        rows = Qb.shape[0]
        run_d = torch.full((rows, k), _BIG, dtype=dt, device=dev)
        run_i = torch.full((rows, k), -1, dtype=torch.int32, device=dev)
        for n0 in range(0, n, bn):
            Xt = items[n0 : n0 + bn]
            with matmul_precision():
                qx = Qb @ Xt.T
            score = torch.where(valid[n0 : n0 + bn], x2[n0 : n0 + bn] - 2.0 * qx, _BIG)
            pos = torch.arange(
                n0, n0 + Xt.shape[0], dtype=torch.int32, device=dev
            ).expand(rows, -1)
            cat_d = torch.cat([run_d, score], dim=1)
            cat_i = torch.cat([run_i, pos], dim=1)
            srt, order = torch.sort(cat_d, dim=1, stable=True)
            run_d = srt[:, :k]
            run_i = torch.gather(cat_i, 1, order[:, :k])
        exhausted = run_d >= _BIG
        q2 = (Qb * Qb).sum(dim=1, keepdim=True)
        out_d[q0 : q0 + rows] = torch.where(
            exhausted, float("inf"), torch.clamp_min(run_d + q2, 0.0)
        )
        out_i[q0 : q0 + rows] = torch.where(exhausted, -1, run_i)
    return out_d, out_i


_LIB = None


def _lib() -> ctypes.CDLL:
    """The built kernel library, with its C signatures declared."""
    global _LIB
    if _LIB is None:
        from . import _build

        lib = _build.load(_SOURCE)
        for fn in (lib.fused_knn_f32, lib.fused_knn_f64):
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 4 + [ctypes.c_void_p] * 3
            fn.restype = ctypes.c_int
        lib.fused_knn_error_string.argtypes = [ctypes.c_int]
        lib.fused_knn_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(items, item_valid, queries, k: int) -> None:
    if items.dim() != 2 or queries.dim() != 2 or item_valid.dim() != 1:
        raise ValueError(
            f"fused_knn takes items (n, d), item_valid (n,), queries (q, d); got "
            f"{tuple(items.shape)}, {tuple(item_valid.shape)}, {tuple(queries.shape)}"
        )
    n, d = items.shape
    q = queries.shape[0]
    if queries.shape[1] != d or item_valid.shape[0] != n:
        raise ValueError(
            f"fused_knn shapes disagree: items {tuple(items.shape)}, "
            f"item_valid {tuple(item_valid.shape)}, queries {tuple(queries.shape)}"
        )
    if items.dtype not in (torch.float32, torch.float64) or queries.dtype != items.dtype:
        raise TypeError(
            f"fused_knn takes float32 or float64 items and queries of one dtype; "
            f"got {items.dtype} and {queries.dtype}"
        )
    devs = {items.device, item_valid.device, queries.device}
    if len(devs) != 1:
        raise ValueError(f"fused_knn inputs lie on different devices: {devs}")
    if not (items.is_contiguous() and queries.is_contiguous()):
        raise ValueError("fused_knn takes row-major contiguous items and queries")
    if not 1 <= k <= _INT32_MAX:
        raise ValueError(f"fused_knn needs 1 <= k < 2^31, got k={k}")
    if max(n, d, q) > _INT32_MAX:
        raise ValueError(
            f"fused_knn indexes items, width and queries with int32; got n={n}, d={d}, q={q}"
        )


def fused_topk_sqdist(
    items: torch.Tensor,
    item_valid: torch.Tensor,
    queries: torch.Tensor,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact brute-force kNN: (squared distances (q, k), int32 item
    POSITIONS (q, k)), best first; invalid items never appear (+inf and
    -1 past the valid count).  CUDA tensors launch the hand-written
    kernel; CPU tensors run `fused_topk_sqdist_reference`."""
    global LAUNCHES
    _check(items, item_valid, queries, k)
    if queries.device.type == "cpu":
        return fused_topk_sqdist_reference(items, item_valid, queries, k)
    if queries.device.type != "cuda":
        raise ValueError(f"fused_knn runs on cuda or cpu tensors, not {queries.device}")
    lib = _lib()
    fn = lib.fused_knn_f32 if items.dtype == torch.float32 else lib.fused_knn_f64
    n, d = items.shape
    q = queries.shape[0]
    dev, dt = queries.device, queries.dtype
    x2 = item_norms(items, item_valid).contiguous()
    valid = (item_valid > 0).to(dt).contiguous()
    out_d = torch.empty((q, k), dtype=dt, device=dev)
    out_i = torch.empty((q, k), dtype=torch.int32, device=dev)
    if q == 0:
        return out_d, out_i
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            items.data_ptr(), x2.data_ptr(), valid.data_ptr(), queries.data_ptr(),
            n, d, q, k, out_d.data_ptr(), out_i.data_ptr(), stream,
        )
    if err != 0:
        msg = lib.fused_knn_error_string(err).decode()
        raise RuntimeError(f"fused_knn kernel launch failed: {msg} (cudaError {err})")
    LAUNCHES += 1
    return out_d, out_i


def knn_topk_fused(items, item_valid, item_ids, queries, k: int):
    """`fused_topk_sqdist` plus the map from positions to `item_ids`
    (-1 stays -1)."""
    d2, pos = fused_topk_sqdist(items, item_valid, queries, k)
    ids = torch.where(pos >= 0, item_ids[pos.clamp_min(0).long()], -1)
    return d2, ids
