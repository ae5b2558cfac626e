#
# Fused distance + top-k for exact kNN: the port of
# spark_rapids_ml_tpu/ops/pallas_knn.py.
#
#   fused_topk_sqdist            the kernels' wrapper.  On a CUDA tensor it
#                                launches the hand-written kernels
#                                (csrc/fused_knn.cu) or raises; on a CPU
#                                tensor it runs the plain twin below.
#   fused_topk_sqdist_reference  the plain PyTorch twin: the TPU kernel's
#                                tile and merge semantics in torch ops, in
#                                IEEE float32 under `matmul_precision()`.
#   tf32_split, fused_knn_tf32,  the float32 path's three kernels (split
#   merge_partials               pass, main kernel, merge pass), each with
#                                its plain version beside it, which CPU
#                                tensors run; `topk_partials` chains the
#                                first two.
#   fused_knn_smallq             the float32 kernel for few queries, with its
#                                plain version `fused_knn_smallq_reference`;
#                                `route` says which kernel a call takes.
#   fused_knn_smallq_f64         its float64 instance (the same plain
#                                version).
#   fused_knn_f64                the float64 main kernel, with its plain
#                                version `fused_knn_f64_reference`; the merge
#                                pass takes float64 too.
#   knn_topk_fused               the wrapper plus the position -> id map.
#
# float32 on the card runs three kernels: the split pass (x -> TF32 hi and
# lo, padded to whole 32-float rows), the main kernel (3xTF32 products on
# the tensor cores, the item sweep split S ways across blocks, selection on
# the accumulators, one sorted partial list per row and split) and the merge
# pass (the S lists by (score, position), then the ||q||^2 epilogue).
# float32 with q <= _SMALL_Q queries and k <= 32 runs two instead: the
# small-q kernel (one pass over the raw items, IEEE float32 FMAs on the
# CUDA cores, the same (q, S, k) lists) and the merge pass.
# float64 on the card runs two: the main kernel (products on the FP64
# tensor cores, the same split sweep and selection) and the merge pass, so
# `float32_inputs=False` keeps float64 inside the kernels (the JAX package
# sends float64 to XLA instead, and bounds d at 4096).  float64 with
# q <= _SMALL_Q_F64 queries and k <= 32 runs the small-q kernel's float64
# instance (IEEE float64 FMAs on the CUDA cores) and the merge pass.  None
# has a width bound.
#
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .precision import matmul_precision

_SOURCE = "fused_knn.cu"
# stand-in for +inf inside the twin's running state, as in the TPU kernel
_BIG = 3.0e38
_INT32_MAX = 2**31 - 1
# tile sizes of the float32 kernel (csrc/fused_knn.cu BN, BQ, BK); the
# float64 kernel's query block and item tile (BQD, BND) are _BQ and _BN too
_BN = 64
_BQ = 128
_BK = 32
# the item sweep is split into at most this many ranges (`auto_splits`),
# each of at least _MIN_SPLIT_TILES tiles, with the (q, S, k) scratch under
# _SPLIT_SCRATCH_BYTES.  _BLOCK_COST is what every block pays besides its
# share of the sweep, as a fraction of one whole sweep (fitted to the split
# sweep that chip_smoke.py prints: 1M x 128 items, k = 32, on an H100)
_MAX_SPLITS = 32
_MIN_SPLIT_TILES = 16
_BLOCK_COST = 0.03
_SPLIT_SCRATCH_BYTES = 256 << 20
# the small-q kernel (csrc SQ_TILE, SqType<T>::QMAX): items per tile,
# queries per block (float32, float64), and the largest k it takes (a
# row's list is one register a lane)
_SQ_TILE = 256
_SQ_QBLOCK = 64
_SQ_QBLOCK_F64 = 32
_SQ_MAX_K = 32
# float32 calls with at most this many queries (and k <= _SQ_MAX_K) take the
# small-q kernel: the largest q of chip_smoke.py's sweep (phase 16, both
# routes called directly, 1M x 128 items, k = 32) at which it is the faster
# route.  ms small-q / 3xTF32 on an H100 80GB HBM3 at 700 W: q = 1 0.242 /
# 2.354, 8 0.334 / 2.559, 64 0.899 / 3.214, 128 1.534 / 3.536, 256 2.793 /
# 3.559, 512 5.469 / 3.581, 1024 10.735 / 5.189 (PERF.md, PR 18).
_SMALL_Q = 256
# float64 calls with at most this many queries (and k <= _SQ_MAX_K) take the
# small-q kernel's float64 instance: the largest q of chip_smoke.py's float64
# sweep (phase 16, both float64 routes called directly, 1M x 128 items,
# k = 32) at which it is the faster route.  ms small-q / main kernel (norms
# pass + DMMA kernel + merge) on an H100 80GB HBM3 at 700 W: q = 1 0.454 /
# 4.641, 8 0.528 / 4.917, 64 1.603 / 5.619, 128 3.038 / 6.056, 256 6.081 /
# 6.032, 512 11.996 / 6.017, 1024 23.751 / 9.973 (PERF.md, PR 19).
_SMALL_Q_F64 = 128

# Launches since the last reset (chip_smoke.py resets them before the main
# path and reads them after), each counted by the wrapper that launches the
# kernel: the float32 main kernel (3xTF32), the float32 small-q kernel (one
# of the two per float32 fused_topk_sqdist call), the float64 main kernel
# and the float64 small-q kernel (one of the two per float64 call), the
# split pass and the merge pass (either type).  The plain versions never
# count.
LAUNCHES = 0
SMALLQ_LAUNCHES = 0
LAUNCHES_F64 = 0
SMALLQ_F64_LAUNCHES = 0
SPLIT_LAUNCHES = 0
MERGE_LAUNCHES = 0


def item_norms(items: torch.Tensor, item_valid: torch.Tensor) -> torch.Tensor:
    """||x||^2 per item, zeroed where the item is invalid."""
    return (items * items).sum(dim=1) * (item_valid > 0).to(items.dtype)


def padded_width(d: int) -> int:
    """d rounded up to whole 32-float (128-byte) rows, at least one."""
    return max(_BK, -(-d // _BK) * _BK)


def split_plan(n: int, splits: int, tile: int = _BN) -> Tuple[int, int]:
    """(tiles per split, number of splits) for an item sweep of n items in
    tiles of `tile` (the main kernels' 64, the small-q kernel's 256) cut
    into at most `splits` ranges.  Split s covers items [s * tps * tile,
    min((s + 1) * tps * tile, n)); no split is empty."""
    tiles = max(1, -(-n // tile))
    tps = -(-tiles // max(1, min(splits, tiles)))
    return tps, -(-tiles // tps)


def split_bounds(n: int, splits: int, tile: int = _BN):
    """The item ranges [lo, hi) of `split_plan(n, splits, tile)`."""
    tps, s = split_plan(n, splits, tile)
    return [(i * tps * tile, min((i + 1) * tps * tile, n)) for i in range(s)]


def auto_splits(n: int, q: int, k: int, sms: int, dtype=torch.float32) -> int:
    """Splits of the item sweep for a card with `sms` SMs, one block per SM
    at a time: the S of least waves(S) * (1 / S + _BLOCK_COST), the time of
    whole waves of blocks that each sweep 1/S of the items and pay a fixed
    cost besides (ties to the fewer splits).  Each split keeps at least
    _MIN_SPLIT_TILES tiles and the (q, S, k) scratch, a score of `dtype`
    and an int32 position per entry, stays under _SPLIT_SCRATCH_BYTES."""
    qblocks = -(-q // _BQ)
    by_items = max(1, -(-n // _BN) // _MIN_SPLIT_TILES)
    entry = 12 if dtype == torch.float64 else 8
    by_bytes = max(1, _SPLIT_SCRATCH_BYTES // max(1, q * k * entry))
    top = max(1, min(_MAX_SPLITS, by_items, by_bytes))

    def cost(s: int) -> float:
        return -(-qblocks * s // sms) * (1.0 / s + _BLOCK_COST)

    return min(range(1, top + 1), key=cost)


def smallq_splits(n: int, q: int, wave: int, qblock: int = _SQ_QBLOCK) -> int:
    """Splits of the small-q kernel's item sweep: one wave of `wave`
    resident blocks (`smallq_wave`) over the ceil(q / qblock) query blocks
    (64 queries a block in float32, `_SQ_QBLOCK_F64` in float64), at most
    one split per 256-item tile."""
    per_block = max(1, wave // -(-q // qblock))
    return max(1, min(per_block, -(-n // _SQ_TILE)))


def route(q: int, k: int, dtype) -> str:
    """The kernel `fused_topk_sqdist` runs on the card, from the call's
    shape and dtype alone: float32 with q <= _SMALL_Q and k <= 32 the
    small-q kernel, other float32 calls the 3xTF32 main kernel; float64
    with q <= _SMALL_Q_F64 and k <= 32 the small-q kernel's float64
    instance, other float64 calls the float64 main kernel.  Each is
    followed by the merge pass."""
    if dtype == torch.float64:
        if q <= _SMALL_Q_F64 and k <= _SQ_MAX_K:
            return "fused_knn_smallq_f64"
        return "fused_knn_f64"
    if q <= _SMALL_Q and k <= _SQ_MAX_K:
        return "fused_knn_smallq"
    return "fused_knn_tf32"


def tf32_split_reference(x: torch.Tensor, d_pad: int) -> torch.Tensor:
    """Plain version of the split pass: (2, rows, d_pad) float32 with
    hi = tf32(x) and lo = tf32(x - hi), zeros in the pad.  tf32() rounds to
    10 mantissa bits, to nearest with ties away from zero (cvt.rna), on the
    bits: add half a unit of the 13 dropped bits, then clear them
    (non-finite values pass unchanged)."""
    rows, d = x.shape
    xp = torch.zeros((rows, d_pad), dtype=torch.float32, device=x.device)
    xp[:, :d] = x

    def rna(v):
        b = v.view(torch.int32)
        r = torch.where(torch.isfinite(v), (b + 0x1000) & -0x2000, b)
        return r.view(torch.float32)

    hi = rna(xp)
    return torch.stack([hi, rna(xp - hi)])


def f64_order_key(x: torch.Tensor) -> torch.Tensor:
    """Plain version of the float64 kernel's shared-bound key (csrc
    `f64_key`): float64 scores as int64 bit patterns whose UNSIGNED order is
    the scores' order (-0.0 as +0.0; NaN is not ordered).  key ^ (1 << 63)
    orders the same as signed int64."""
    b = torch.where(x == 0, torch.zeros_like(x), x).view(torch.int64)
    return torch.where(b < 0, ~b, b | torch.iinfo(torch.int64).min)


def merge_partials_reference(
    part_d: torch.Tensor,  # (q, S, k) sorted partial scores, +inf where empty
    part_i: torch.Tensor,  # (q, S, k) int32 positions, -1 where empty
    q2: torch.Tensor,  # (q,) ||q||^2
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the merge pass: the k least (score, position) of
    each row's S lists, then d^2 = max(score + ||q||^2, 0), +inf and -1 past
    the valid count.  Split s holds lower positions than split s + 1 and
    each list is in (score, position) order, so a stable sort by score over
    the lists laid end to end orders ties by position."""
    rows, s, kk = part_d.shape
    cat_d = part_d.reshape(rows, s * kk)
    cat_i = part_i.reshape(rows, s * kk)
    srt, order = torch.sort(cat_d, dim=1, stable=True)
    top_d, top_i = srt[:, :k], torch.gather(cat_i, 1, order[:, :k])
    empty = top_i < 0
    out_d = torch.where(empty, float("inf"), torch.clamp_min(top_d + q2[:, None], 0.0))
    return out_d, torch.where(empty, -1, top_i)


def _split_topk(score_tile, n: int, q: int, k: int, splits: int, bq: int, bn: int, dt, dev,
                tile: int = _BN):
    """Each row's sorted (score, position) list of every item range of
    `split_bounds(n, splits, tile)`: (q, S, k) scores, +inf where empty, and
    int32 positions, -1 where empty.  Query rows go in blocks of `bq`, a range's
    items in tiles of `bn`; `score_tile(q0, q1, n0, n1)` gives a tile's
    scores, >= _BIG where the item is invalid.  Each tile joins the running
    (rows, k) state of its range, and a stable sort keeps the k least, so
    ties go to the lowest position exactly as the TPU kernel's first-argmin
    does."""
    bounds = split_bounds(n, splits, tile)
    part_d = torch.empty((q, len(bounds), k), dtype=dt, device=dev)
    part_i = torch.empty((q, len(bounds), k), dtype=torch.int32, device=dev)
    bq = min(bq, max(8, q))
    for q0 in range(0, q, bq):
        q1 = min(q0 + bq, q)
        for s, (lo, hi) in enumerate(bounds):
            run_d = torch.full((q1 - q0, k), _BIG, dtype=dt, device=dev)
            run_i = torch.full((q1 - q0, k), -1, dtype=torch.int32, device=dev)
            for n0 in range(lo, hi, bn):
                n1 = min(n0 + bn, hi)
                pos = torch.arange(n0, n1, dtype=torch.int32, device=dev).expand(q1 - q0, -1)
                cat_d = torch.cat([run_d, score_tile(q0, q1, n0, n1)], dim=1)
                cat_i = torch.cat([run_i, pos], dim=1)
                srt, order = torch.sort(cat_d, dim=1, stable=True)
                run_d = srt[:, :k]
                run_i = torch.gather(cat_i, 1, order[:, :k])
            exhausted = run_d >= _BIG
            part_d[q0:q1, s] = torch.where(exhausted, float("inf"), run_d)
            part_i[q0:q1, s] = torch.where(exhausted, -1, run_i)
    return part_d, part_i


def fused_knn_tf32_reference(xsplit, qsplit, xs, n: int, k: int, splits: int,
                             bq: int = 256, bn: int = 512):
    """Plain version of the float32 main kernel, on its inputs: 3xTF32
    scores xs - 2 (q_hi.x_lo + q_lo.x_hi + q_hi.x_hi), each product a
    float32 matmul (a product of two TF32 values is exact in float32, as
    in the tensor cores, and the sums are float32), then the (q, S, k)
    sorted partial lists of `_split_topk`."""
    (xh, xl), (qh, ql) = xsplit, qsplit
    inf = torch.isinf(xs)

    def score_tile(q0, q1, n0, n1):
        a_hi, a_lo, b_hi, b_lo = qh[q0:q1], ql[q0:q1], xh[n0:n1], xl[n0:n1]
        before = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            acc = a_hi @ b_lo.T + a_lo @ b_hi.T + a_hi @ b_hi.T
        finally:
            torch.backends.cuda.matmul.allow_tf32 = before
        return torch.where(inf[n0:n1], _BIG, xs[n0:n1] - 2.0 * acc)

    return _split_topk(score_tile, n, qh.shape[0], k, splits, bq, bn, xs.dtype, xs.device)


def fused_knn_f64_reference(items, xs, queries, k: int, splits: int,
                            bq: int = 256, bn: int = 512):
    """Plain version of the float64 main kernel, on its inputs (items and
    queries (n, d), (q, d) float64, xs from `padded_item_norms`): IEEE
    float64 scores xs - 2 q.x, +BIG where the item is invalid, then the
    (q, S, k) sorted partial lists of `_split_topk`."""
    n = items.shape[0]
    inf = torch.isinf(xs[:n])

    def score_tile(q0, q1, n0, n1):
        qx = queries[q0:q1] @ items[n0:n1].T
        return torch.where(inf[n0:n1], _BIG, xs[n0:n1] - 2.0 * qx)

    return _split_topk(score_tile, n, queries.shape[0], k, splits, bq, bn, xs.dtype, xs.device)


def _ieee_score_tile(items, item_valid, queries):
    """The twin's scores: ||x||^2 - 2 q.x in IEEE arithmetic under
    `matmul_precision()`, +BIG where the item is invalid, as a
    `_split_topk` score_tile."""
    x2 = item_norms(items, item_valid)
    valid = item_valid > 0

    def score_tile(q0, q1, n0, n1):
        with matmul_precision():
            qx = queries[q0:q1] @ items[n0:n1].T
        return torch.where(valid[n0:n1], x2[n0:n1] - 2.0 * qx, _BIG)

    return score_tile


def fused_knn_smallq_reference(items, item_valid, queries, k: int, splits: int,
                               bq: int = 256, bn: int = 512):
    """Plain version of the small-q kernel in either type: the twin's IEEE
    scores in the inputs' type (`_ieee_score_tile`), then the (q, S, k)
    sorted partial lists of `_split_topk` over the item ranges of
    `split_plan(n, splits, 256)`."""
    return _split_topk(_ieee_score_tile(items, item_valid, queries), items.shape[0],
                       queries.shape[0], k, splits, bq, bn, queries.dtype, queries.device,
                       tile=_SQ_TILE)


def fused_topk_sqdist_reference(
    items: torch.Tensor,  # (n, d)
    item_valid: torch.Tensor,  # (n,) > 0 for a real item
    queries: torch.Tensor,  # (q, d)
    k: int,
    bq: int = 256,
    bn: int = 512,
    splits: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of the fused kernels: (squared distances (q, k),
    int32 item POSITIONS (q, k)), best first.

    Scores ||x||^2 - 2 q.x (+BIG where invalid), in IEEE arithmetic under
    `matmul_precision()`, go through `_split_topk` (query blocks of `bq`,
    item tiles of `bn`, the item ranges of `split_bounds(n, splits)`), and
    `merge_partials_reference` joins the ranges' lists, adds ||q||^2 and
    clamps at 0, with +inf and -1 past the valid count.  Every `splits`
    gives the same result."""
    part_d, part_i = _split_topk(_ieee_score_tile(items, item_valid, queries), items.shape[0],
                                 queries.shape[0], k, splits, bq, bn, queries.dtype,
                                 queries.device)
    return merge_partials_reference(part_d, part_i, (queries * queries).sum(dim=1), k)


_LIB = None


def _lib() -> ctypes.CDLL:
    """The built kernel library, with its C signatures declared."""
    global _LIB
    if _LIB is None:
        from . import _build

        lib = _build.load(_SOURCE)
        ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
        sigs = {
            "tf32_split": [ptr, i64, i64, i64, ptr, ptr],
            "fused_knn_tf32": [ptr] * 3 + [i64] * 6 + [ptr] * 4,
            "merge_partials": [ptr] * 3 + [i64] * 4 + [ptr] * 3,
            "fused_knn_f64": [ptr] * 3 + [i64] * 6 + [ptr] * 4,
            "fused_knn_smallq": [ptr] * 3 + [i64] * 6 + [ptr] * 4,
            "fused_knn_smallq_f64": [ptr] * 3 + [i64] * 6 + [ptr] * 4,
        }
        for name, argtypes in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        for name, argtypes in (("fused_knn_tf32_smem_bytes", [i64]),
                               ("fused_knn_tf32_stages", [i64]),
                               ("fused_knn_f64_smem_bytes", [i64]),
                               ("fused_knn_smallq_wave", [i64]),
                               ("fused_knn_smallq_f64_wave", [i64])):
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = i64
        lib.fused_knn_error_string.argtypes = [ctypes.c_int]
        lib.fused_knn_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _run(name: str, device: torch.device, *args) -> None:
    """Call the C launcher `name` on the device's current stream; raise on
    the error code it returns."""
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, name)(*args, stream)
    if err != 0:
        msg = lib.fused_knn_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} (code {err})")


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"fused_knn runs on cuda or cpu tensors, not {t.device}")
    return True


def tf32_split(x: torch.Tensor, d_pad: int) -> torch.Tensor:
    """The split pass: (2, rows, d_pad) float32 TF32 hi and lo of a
    contiguous float32 (rows, d).  CUDA tensors launch the kernel; CPU
    tensors run `tf32_split_reference`."""
    global SPLIT_LAUNCHES
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError("tf32_split takes a contiguous float32 (rows, d) tensor")
    if d_pad < x.shape[1] or d_pad % _BK:
        raise ValueError(f"tf32_split: d_pad={d_pad} must be a multiple of {_BK} >= d")
    if not _on_cuda(x):
        return tf32_split_reference(x, d_pad)
    rows, d = x.shape
    out = torch.empty((2, rows, d_pad), dtype=torch.float32, device=x.device)
    if rows:
        _run("tf32_split", x.device, x.data_ptr(), rows, d, d_pad, out.data_ptr())
        SPLIT_LAUNCHES += 1
    return out


def merge_partials(part_d, part_i, q2, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The merge pass, float32 or float64 (scores and query norms of one
    type): see `merge_partials_reference`, which CPU tensors run; CUDA
    tensors launch the kernel."""
    global MERGE_LAUNCHES
    if part_d.dtype not in (torch.float32, torch.float64) or q2.dtype != part_d.dtype:
        raise TypeError(f"merge_partials takes float32 or float64 scores and query norms of one "
                        f"dtype; got {part_d.dtype} and {q2.dtype}")
    if not _on_cuda(part_d):
        return merge_partials_reference(part_d, part_i, q2, k)
    q, s, kk = part_d.shape
    if kk != k or part_i.dtype != torch.int32 or part_i.shape != part_d.shape or q2.shape != (q,):
        raise ValueError("merge_partials takes (q, S, k) scores, int32 positions and (q,) "
                         "query norms")
    part_d, part_i, q2 = part_d.contiguous(), part_i.contiguous(), q2.contiguous()
    out_d = torch.empty((q, k), dtype=part_d.dtype, device=part_d.device)
    out_i = torch.empty((q, k), dtype=torch.int32, device=part_d.device)
    if q:
        _run("merge_partials", part_d.device, part_d.data_ptr(), part_i.data_ptr(),
             q2.data_ptr(), q, s, k, int(part_d.dtype == torch.float64), out_d.data_ptr(),
             out_i.data_ptr())
        MERGE_LAUNCHES += 1
    return out_d, out_i


def padded_item_norms(items: torch.Tensor, item_valid: torch.Tensor) -> torch.Tensor:
    """The float32 main kernel's item norms: ||x||^2, +inf where the item
    is invalid, padded with +inf to whole tiles of 64 items."""
    n = items.shape[0]
    xs = torch.full((-(-n // _BN) * _BN,), float("inf"), dtype=items.dtype, device=items.device)
    xs[:n] = torch.where(item_valid > 0, item_norms(items, item_valid), float("inf"))
    return xs


def fused_knn_tf32(xsplit, qsplit, xs, n: int, k: int, splits: int):
    """The float32 main kernel on split items (2, n, d_pad) and queries
    (2, q, d_pad), with xs from `padded_item_norms`: the (q, S, k) sorted
    partial (score, position) lists, S = `split_plan(n, splits)[1]`.  CUDA
    tensors launch the kernel; CPU tensors run `fused_knn_tf32_reference`.
    On the card a split keeps only entries that beat the k-th entry other
    splits of the row have reached, so its list may end early; the lists
    merged (`merge_partials`) give the same top-k."""
    global LAUNCHES
    if not _on_cuda(qsplit):
        return fused_knn_tf32_reference(xsplit, qsplit, xs, n, k, splits)
    q, d_pad = qsplit.shape[1], qsplit.shape[2]
    if not all(t.is_contiguous() and t.dtype == torch.float32 for t in (xsplit, qsplit, xs)) \
            or xsplit.shape != (2, n, d_pad) or qsplit.shape[0] != 2 \
            or xs.shape != (-(-n // _BN) * _BN,):
        raise ValueError("fused_knn_tf32 takes contiguous float32 split arrays from tf32_split "
                         "and item norms from padded_item_norms")
    tps, s = split_plan(n, splits)
    part_d = torch.empty((q, s, k), dtype=torch.float32, device=qsplit.device)
    part_i = torch.empty((q, s, k), dtype=torch.int32, device=qsplit.device)
    row_kth = torch.full((q,), -1, dtype=torch.int64, device=qsplit.device)  # all ones
    _run("fused_knn_tf32", qsplit.device, xsplit.data_ptr(), qsplit.data_ptr(), xs.data_ptr(),
         n, q, d_pad, k, tps, s, part_d.data_ptr(), part_i.data_ptr(), row_kth.data_ptr())
    LAUNCHES += 1
    return part_d, part_i


def fused_knn_f64(items, queries, xs, k: int, splits: int):
    """The float64 main kernel on contiguous float64 items (n, d) and
    queries (q, d), with xs from `padded_item_norms`: the (q, S, k) sorted
    partial (score, position) lists, S = `split_plan(n, splits)[1]`.  CUDA
    tensors launch the kernel; CPU tensors run `fused_knn_f64_reference`.
    On the card a split keeps only entries whose score does not exceed the
    k-th score other splits of the row have reached, so its list may end
    early; the lists merged (`merge_partials`) give the same top-k."""
    global LAUNCHES_F64
    if not _on_cuda(queries):
        return fused_knn_f64_reference(items, xs, queries, k, splits)
    (n, d), q = items.shape, queries.shape[0]
    if not all(t.is_contiguous() and t.dtype == torch.float64 for t in (items, queries, xs)) \
            or queries.shape[1] != d or xs.shape != (-(-n // _BN) * _BN,):
        raise ValueError("fused_knn_f64 takes contiguous float64 items, queries of the same "
                         "width and item norms from padded_item_norms")
    tps, s = split_plan(n, splits)
    part_d = torch.empty((q, s, k), dtype=torch.float64, device=queries.device)
    part_i = torch.empty((q, s, k), dtype=torch.int32, device=queries.device)
    row_kth = torch.full((q,), -1, dtype=torch.int64, device=queries.device)  # all ones
    _run("fused_knn_f64", queries.device, items.data_ptr(), queries.data_ptr(), xs.data_ptr(),
         n, q, d, k, tps, s, part_d.data_ptr(), part_i.data_ptr(), row_kth.data_ptr())
    LAUNCHES_F64 += 1
    return part_d, part_i


_SMALLQ_WAVE = {}


def smallq_wave(device: torch.device, q: int, dtype=torch.float32) -> int:
    """Blocks of the small-q kernel of `dtype` for q queries that the card
    holds at once (the CUDA occupancy of its instance), cached per card,
    type and instance."""
    f64 = dtype == torch.float64
    qt = min(_SQ_QBLOCK_F64 if f64 else _SQ_QBLOCK, 1 << max(0, q - 1).bit_length())
    key = (torch.device(device).index, f64, qt)
    if key not in _SMALLQ_WAVE:
        lib = _lib()
        with torch.cuda.device(device):
            wave = (lib.fused_knn_smallq_f64_wave if f64 else lib.fused_knn_smallq_wave)(qt)
        if wave < 1:
            raise RuntimeError(f"small-q wave query failed: "
                               f"{lib.fused_knn_error_string(int(-1 - wave)).decode()}")
        _SMALLQ_WAVE[key] = wave
    return _SMALLQ_WAVE[key]


def _smallq_check(name: str, dtype, items, item_valid, queries, k: int, splits: int) -> None:
    """Raise ValueError on what the small-q kernel of `dtype` does not take."""
    if not all(t.dtype == dtype and t.is_contiguous() for t in (items, item_valid, queries)) \
            or items.dim() != 2 or queries.dim() != 2 or queries.shape[1] != items.shape[1] \
            or item_valid.shape != (items.shape[0],):
        raise ValueError(f"{name} takes contiguous {str(dtype)[6:]} items (n, d), item_valid "
                         "(n,) and queries (q, d)")
    (n, d), q = items.shape, queries.shape[0]
    if not 1 <= k <= _SQ_MAX_K or n < 1 or q < 1 or splits < 1:
        raise ValueError(f"{name} takes 1 <= k <= {_SQ_MAX_K}, n >= 1, q >= 1 and "
                         f"splits >= 1; got k={k}, n={n}, q={q}, splits={splits}")
    if max(n, d, q) > _INT32_MAX:
        raise ValueError(f"{name} indexes with int32; got n={n}, d={d}, q={q}")


def _smallq_launch(name: str, items, item_valid, queries, k: int, splits: int):
    """Launch the small-q kernel `name` (C entry of the same name): the
    (q, S, k) partial lists in the items' dtype."""
    (n, d), q = items.shape, queries.shape[0]
    tps, s = split_plan(n, splits, _SQ_TILE)
    part_d = torch.empty((q, s, k), dtype=items.dtype, device=queries.device)
    part_i = torch.empty((q, s, k), dtype=torch.int32, device=queries.device)
    row_kth = torch.full((q,), -1, dtype=torch.int64, device=queries.device)  # all ones
    _run(name, queries.device, items.data_ptr(), item_valid.data_ptr(), queries.data_ptr(), n, q,
         d, k, tps, s, part_d.data_ptr(), part_i.data_ptr(), row_kth.data_ptr())
    return part_d, part_i


def fused_knn_smallq(items, item_valid, queries, k: int, splits: int):
    """The small-q kernel on contiguous float32 items (n, d), item_valid
    (n,) and queries (q, d), k <= 32: the (q, S, k) sorted partial
    (score, position) lists, S = `split_plan(n, splits, 256)[1]`.  CUDA
    tensors launch the kernel; CPU tensors run
    `fused_knn_smallq_reference`.  On the card a split keeps only entries
    that beat the k-th entry other splits of the row have reached, so its
    list may end early; the lists merged (`merge_partials`) give the same
    top-k."""
    global SMALLQ_LAUNCHES
    _smallq_check("fused_knn_smallq", torch.float32, items, item_valid, queries, k, splits)
    if not _on_cuda(queries):
        return fused_knn_smallq_reference(items, item_valid, queries, k, splits)
    out = _smallq_launch("fused_knn_smallq", items, item_valid, queries, k, splits)
    SMALLQ_LAUNCHES += 1
    return out


def fused_knn_smallq_f64(items, item_valid, queries, k: int, splits: int):
    """The small-q kernel's float64 instance on contiguous float64 items
    (n, d), item_valid (n,) and queries (q, d), k <= 32: the (q, S, k)
    sorted partial (score, position) lists, S = `split_plan(n, splits,
    256)[1]`.  CUDA tensors launch the kernel; CPU tensors run
    `fused_knn_smallq_reference`.  On the card a split keeps only
    entries whose score does not exceed the k-th score other splits of the
    row have reached (as the float64 main kernel), so its list may end
    early; the lists merged (`merge_partials`) give the same top-k."""
    global SMALLQ_F64_LAUNCHES
    _smallq_check("fused_knn_smallq_f64", torch.float64, items, item_valid, queries, k, splits)
    if not _on_cuda(queries):
        return fused_knn_smallq_reference(items, item_valid, queries, k, splits)
    out = _smallq_launch("fused_knn_smallq_f64", items, item_valid, queries, k, splits)
    SMALLQ_F64_LAUNCHES += 1
    return out


def topk_partials(items, item_valid, queries, k: int, splits: int):
    """float32 on the card, up to the merge: the split passes and the main
    kernel, giving each row's (S, k) sorted partial lists."""
    d_pad = padded_width(items.shape[1])
    return fused_knn_tf32(tf32_split(items, d_pad), tf32_split(queries, d_pad),
                          padded_item_norms(items, item_valid), items.shape[0], k, splits)


def _check(items, item_valid, queries, k: int, splits: Optional[int]) -> None:
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
    if splits is not None and splits < 1:
        raise ValueError(f"fused_knn needs splits >= 1, got {splits}")
    if max(n, padded_width(d), q) > _INT32_MAX:
        raise ValueError(
            f"fused_knn indexes items, width and queries with int32; got n={n}, d={d}, q={q}"
        )


def fused_topk_sqdist(
    items: torch.Tensor,
    item_valid: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    splits: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact brute-force kNN: (squared distances (q, k), int32 item
    POSITIONS (q, k)), best first; invalid items never appear (+inf and
    -1 past the valid count).  CUDA tensors launch the hand-written
    kernels `route(q, k, dtype)` names, then the merge pass; CPU tensors
    run `fused_topk_sqdist_reference`.  `splits` cuts the item sweep into
    that many ranges (default: `smallq_splits` or `auto_splits` on the
    card, 1 on the CPU); it never changes the result."""
    _check(items, item_valid, queries, k, splits)
    if not _on_cuda(queries):
        return fused_topk_sqdist_reference(items, item_valid, queries, k, splits=splits or 1)
    n, q = items.shape[0], queries.shape[0]
    dev, dt = queries.device, queries.dtype
    if q == 0 or n == 0:
        return (torch.full((q, k), float("inf"), dtype=dt, device=dev),
                torch.full((q, k), -1, dtype=torch.int32, device=dev))
    kernel = route(q, k, dt)
    if kernel == "fused_knn_smallq":
        part_d, part_i = fused_knn_smallq(
            items, item_valid.to(torch.float32).contiguous(), queries, k,
            splits or smallq_splits(n, q, smallq_wave(dev, q)))
    elif kernel == "fused_knn_smallq_f64":
        part_d, part_i = fused_knn_smallq_f64(
            items, item_valid.to(torch.float64).contiguous(), queries, k,
            splits or smallq_splits(n, q, smallq_wave(dev, q, dt), _SQ_QBLOCK_F64))
    else:
        if splits is None:
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            splits = auto_splits(n, q, k, sms, dt)
        if kernel == "fused_knn_f64":
            part_d, part_i = fused_knn_f64(items, queries, padded_item_norms(items, item_valid),
                                           k, splits)
        else:
            part_d, part_i = topk_partials(items, item_valid, queries, k, splits)
    return merge_partials(part_d, part_i, (queries * queries).sum(dim=1), k)


def knn_topk_fused(items, item_valid, item_ids, queries, k: int):
    """`fused_topk_sqdist` plus the map from positions to `item_ids`
    (-1 stays -1)."""
    d2, pos = fused_topk_sqdist(items, item_valid, queries, k)
    ids = torch.where(pos >= 0, item_ids[pos.clamp_min(0).long()], -1)
    return d2, ids
