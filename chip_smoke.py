#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (spark_rapids_ml_torch) on one NVIDIA GPU.

Run from the root of a checkout:

    python3 chip_smoke.py [--seed 0] [--items 1000000] [--queries 10000]
                          [--dim 128] [--k 32]

Phases, each of which makes the script exit non-zero when it fails:

1. card: the GPU's name and power limit, the torch and CUDA versions, and
   the build of every CUDA kernel of the port from the sources in the
   checkout (nvcc, one process per source, all started together);
2. kernel vs twin: the fused distance + top-k kernel against its plain
   PyTorch twin, both on the card, at shapes with tails (k > valid
   items), invalid rows, exact ties (duplicated integer rows), widths that
   are no multiple of the kernel's chunk, float32 and float64, and
   k = 1, 32 and 1000;
3. the main path at full size: NearestNeighbors(k).setIdCol("id").fit(items)
   -> kneighbors(queries) -> exactNearestNeighborsJoin, through the public
   entry points; the kernel's launch count is reset just before and read
   just after.  Then the result is held against the twin on the same
   staged tensors and against a float64 host recomputation, and the
   kernel, the twin and one library call computing the same function (a
   blocked torch.matmul + torch.topk, the yardstick) are timed with CUDA
   events;
4. persistence: save, load, kneighbors again, identical results.

The last lines of standard output are a JSON object of the kernels'
numbers, the card's name and power limit, and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
No JAX is imported.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# Published peaks of one H100 SXM at its full 700 W (NVIDIA's data sheet):
# float32 outside the tensor cores, float64 outside the tensor cores, HBM.
_PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
_PEAK_BYTES_PER_S = 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of `fn` over `reps` runs (after one warm run)."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# Relative d^2 tolerance of a kernel that sums in another order than its
# twin.  float64 gets its own, far below what a float32 body could reach.
_RTOL = {"torch.float32": 1e-4, "torch.float64": 1e-10}


def compare(name, kd, ki, td, ti, exact: bool) -> float:
    """Hold kernel output (kd, ki) against the twin's (td, ti).  Exact cases
    must agree bit for bit; others may differ by summation order: every
    finite d^2 within rtol * max(1, d^2) of the twin's (rtol by dtype,
    `_RTOL`), so every id slot that differs is a tie within that
    tolerance; the same +inf/-1 tails; at least 99.9% of id slots equal."""
    rtol = _RTOL[str(td.dtype)]
    kd, td = kd.cpu().double().numpy(), td.cpu().double().numpy()
    ki, ti = ki.cpu().numpy(), ti.cpu().numpy()
    fin = np.isfinite(td)
    if not np.array_equal(fin, np.isfinite(kd)) or not np.array_equal(ki < 0, ti < 0):
        raise AssertionError(f"{name}: +inf/-1 tails differ between kernel and twin")
    err = float(np.abs(kd[fin] - td[fin]).max()) if fin.any() else 0.0
    agree = float((ki == ti).mean()) if ki.size else 1.0
    log(f"  {name}: max|d2 kernel - d2 twin| = {err:.3e}, id slots equal = {agree:.6f}")
    if exact:
        if not (np.array_equal(ki, ti) and np.array_equal(kd[fin], td[fin])):
            raise AssertionError(f"{name}: exact case differs (ids must match slot for slot)")
        return err
    tol = rtol * np.maximum(1.0, np.abs(td[fin]))
    if not (np.abs(kd[fin] - td[fin]) <= tol).all():
        raise AssertionError(f"{name}: d2 differs beyond {rtol:g} * max(1, d2)")
    if agree < 0.999:
        raise AssertionError(f"{name}: only {agree:.4%} of id slots agree")
    return err


def phase_kernel_vs_twin(device, seed: int) -> None:
    import torch

    from spark_rapids_ml_torch.ops import fused_knn as fk

    rng = np.random.default_rng(seed)
    f32, f64 = torch.float32, torch.float64
    cases = []  # (name, items, valid, queries, k, dtype, exact)
    X = rng.normal(size=(3000, 40))
    v = np.ones(3000)
    v[-200:] = 0.0
    v[::7] = 0.0  # invalid rows inside the set, not only at the tail
    cases.append(("padded/invalid rows f32 k=32", X, v, rng.normal(size=(130, 40)), 32, f32, False))
    v = np.zeros(300)
    v[:4] = 1.0
    cases.append(("tails k>valid f32 k=7", rng.normal(size=(300, 6)), v,
                  rng.normal(size=(10, 6)), 7, f32, False))
    Xi = rng.integers(-3, 4, size=(1000, 17)).astype(np.float64)
    Xi[500:] = Xi[:500]  # every row twice: exact ties broken by position
    Qi = rng.integers(-3, 4, size=(70, 17)).astype(np.float64)
    for dt, tag in ((f32, "f32"), (f64, "f64")):
        cases.append((f"exact ties {tag} k=32", Xi, np.ones(1000), Qi, 32, dt, True))
    cases.append(("d=131 f32 k=1", rng.normal(size=(2000, 131)), np.ones(2000),
                  rng.normal(size=(65, 131)), 1, f32, False))
    cases.append(("d=4100 f32 k=5", rng.normal(size=(300, 4100)), np.ones(300),
                  rng.normal(size=(9, 4100)), 5, f32, False))
    cases.append(("f64 d=40 k=32", rng.normal(size=(3000, 40)), np.ones(3000),
                  rng.normal(size=(100, 40)), 32, f64, False))
    # small integers plus multiples of 2^-30 need 32 significant bits:
    # float32 rounds the offsets away, so a float32 body misses 1e-10
    def beyond_f32(rows, cols):
        return (rng.integers(-3, 4, size=(rows, cols))
                + rng.integers(1, 256, size=(rows, cols)) * 2.0**-30)

    cases.append(("f64 beyond f32 precision k=16", beyond_f32(2000, 33), np.ones(2000),
                  beyond_f32(50, 33), 16, f64, False))
    for dt, tag in ((f32, "f32"), (f64, "f64")):
        cases.append((f"{tag} k=1000", rng.normal(size=(5000, 24)), np.ones(5000),
                      rng.normal(size=(66, 24)), 1000, dt, False))
    for name, X, v, Q, k, dt, exact in cases:
        Xt = torch.as_tensor(X, dtype=dt, device=device).contiguous()
        vt = torch.as_tensor(v, dtype=dt, device=device)
        Qt = torch.as_tensor(Q, dtype=dt, device=device).contiguous()
        kd, ki = fk.fused_topk_sqdist(Xt, vt, Qt, k)
        td, ti = fk.fused_topk_sqdist_reference(Xt, vt, Qt, k)
        torch.cuda.synchronize()
        compare(name, kd, ki, td, ti, exact)
    if fk.LAUNCHES < len(cases):
        raise AssertionError(f"kernel launched {fk.LAUNCHES} times for {len(cases)} cases")


def phase_main_path(device, args) -> dict:
    import torch

    from spark_rapids_ml_torch.knn import NearestNeighbors
    from spark_rapids_ml_torch.ops import fused_knn as fk
    from spark_rapids_ml_torch.ops.knn import LAST_KERNEL_DECISION

    n, q, d, k = args.items, args.queries, args.dim, args.k
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    items = rng.standard_normal(size=(n, d), dtype=np.float32)
    queries = rng.standard_normal(size=(q, d), dtype=np.float32)
    item_ids = np.arange(n, dtype=np.int64) * 7 + 11  # user ids, not positions
    query_ids = np.arange(q, dtype=np.int64) + 5_000_000
    log(f"  data: items {items.shape} queries {queries.shape} float32, seed {args.seed}, "
        f"{time.perf_counter() - t0:.2f} s")

    fk.LAUNCHES = 0
    t0 = time.perf_counter()
    model = NearestNeighbors(k=k).setIdCol("id").fit({"features": items, "id": item_ids})
    t_fit = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, _, knn_df = model.kneighbors({"features": queries, "id": query_ids})
    t_kn = time.perf_counter() - t0
    t0 = time.perf_counter()
    join = model.exactNearestNeighborsJoin({"features": queries, "id": query_ids})
    t_join = time.perf_counter() - t0
    launches = fk.LAUNCHES
    decision = dict(LAST_KERNEL_DECISION)
    log(f"  fit {t_fit:.3f} s; kneighbors {t_kn:.3f} s (items staged, {q / t_kn:.1f} queries/s); "
        f"join {t_join:.3f} s (items resident, {q / t_join:.1f} queries/s)")
    log(f"  kernel launches on the main path: {launches}; LAST_KERNEL_DECISION {decision}")
    if decision["kernel"] != "fused_knn.cu" or launches < 1:
        raise AssertionError("the main path did not run the CUDA kernel")

    idx = np.stack(knn_df["indices"])
    dist = np.stack(knn_df["distances"])
    if idx.shape != (q, k) or not np.isfinite(dist).all():
        raise AssertionError(f"kneighbors gave {idx.shape}, finite={np.isfinite(dist).all()}")
    if len(join["item_id"]) != q * k:
        raise AssertionError("the join has the wrong number of rows")

    # the same staged tensors the main path used
    items_t, valid_t, _ = model._device_items[1]
    queries_t = torch.as_tensor(queries, device=device)
    kd, kp = fk.fused_topk_sqdist(items_t, valid_t, queries_t, k)
    td, tp = fk.fused_topk_sqdist_reference(items_t, valid_t, queries_t, k, bq=1024, bn=8192)
    torch.cuda.synchronize()
    err = compare("main path: kernel vs twin", kd, kp, td, tp, exact=False)
    kd_h, kp_h = kd.cpu().numpy(), kp.cpu().numpy()
    if not (np.array_equal(idx, item_ids[kp_h])
            and np.allclose(dist, np.sqrt(kd_h), rtol=1e-6, atol=1e-6)):
        raise AssertionError("kneighbors output differs from a direct kernel call")
    sample = np.random.default_rng(args.seed + 1).choice(q, size=min(256, q), replace=False)
    exact = ((items[kp_h[sample]].astype(np.float64)
              - queries[sample, None, :].astype(np.float64)) ** 2).sum(-1)
    rel = np.abs(kd_h[sample] - exact) / np.maximum(exact, 1e-30)
    log(f"  float64 host recomputation on {len(sample)} queries: max relative |d2 error| = "
        f"{rel.max():.3e}")
    if rel.max() > 1e-4:
        raise AssertionError("kernel d2 differs from the float64 recomputation beyond 1e-4")

    # the H2D staging layer alone: the items through RowStager once more
    from spark_rapids_ml_torch.parallel import RowStager

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    RowStager(n, device).stage(items, np.float32)
    torch.cuda.synchronize()
    t_stage = time.perf_counter() - t0
    log(f"  staging {items.nbytes / 1e6:.0f} MB of items: {t_stage:.3f} s "
        f"({items.nbytes / t_stage / 1e9:.2f} GB/s)")

    ms = cuda_ms(lambda: fk.fused_topk_sqdist(items_t, valid_t, queries_t, k), reps=3)
    plain_ms = cuda_ms(
        lambda: fk.fused_topk_sqdist_reference(items_t, valid_t, queries_t, k, bq=1024, bn=8192),
        reps=1,
    )

    def library_call():
        # one blocked torch.matmul + torch.topk over the same inputs, IEEE f32
        x2 = (items_t * items_t).sum(1)
        before = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            for q0 in range(0, q, 1024):
                Qb = queries_t[q0 : q0 + 1024]
                d2 = (Qb * Qb).sum(1, keepdim=True) - 2.0 * (Qb @ items_t.T) + x2
                torch.topk(d2, k, dim=1, largest=False)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = before

    library_ms = cuda_ms(library_call, reps=2)
    flops = 2.0 * q * n * d
    nbytes = 4.0 * (n * d + q * d + 2 * n) + 8.0 * q * k  # inputs once, outputs once
    t_ops = flops / _PEAK_FLOPS["float32"] * 1e3
    t_bytes = nbytes / _PEAK_BYTES_PER_S * 1e3
    log(f"  kernel {ms:.3f} ms ({q / ms * 1e3:.1f} queries/s, {flops / ms / 1e9:.2f} TFLOP/s); "
        f"twin {plain_ms:.3f} ms; library matmul+topk {library_ms:.3f} ms; "
        f"bound {max(t_ops, t_bytes):.3f} ms ({'operations' if t_ops >= t_bytes else 'bytes'})")
    return {
        "model": model,
        "queries": queries,
        "query_ids": query_ids,
        "knn_df": knn_df,
        "kernel": {
            "name": "fused_knn",
            "route": "cuda",
            "source": "spark_rapids_ml_torch/ops/csrc/fused_knn.cu",
            "replaces": "spark_rapids_ml_tpu/ops/pallas_knn.py:148",
            "launches": launches,
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms,
        },
    }


def phase_persistence(main: dict) -> None:
    from spark_rapids_ml_torch.knn import NearestNeighborsModel

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "nn_model")
        t0 = time.perf_counter()
        main["model"].save(path)
        loaded = NearestNeighborsModel.load(path)
        t_io = time.perf_counter() - t0
        _, _, again = loaded.kneighbors({"features": main["queries"], "id": main["query_ids"]})
    a, b = main["knn_df"], again
    same = (np.array_equal(np.stack(a["indices"]), np.stack(b["indices"]))
            and np.array_equal(np.stack(a["distances"]), np.stack(b["distances"]))
            and np.array_equal(np.asarray(a["query_id"]), np.asarray(b["query_id"])))
    log(f"  save + load {t_io:.2f} s; kneighbors after load identical: {same}")
    if not same:
        raise AssertionError("the loaded model answers differently")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--items", type=int, default=1_000_000)
    ap.add_argument("--queries", type=int, default=10_000)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--k", type=int, default=32)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from spark_rapids_ml_torch import set_default_device
    from spark_rapids_ml_torch.ops import _build

    t_start = time.perf_counter()
    device = torch.device("cuda:0")
    set_default_device(device)

    log("phase 1: card")
    card = card_line()
    log(f"  {card}")
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    # kneighbors builds its result as a pandas DataFrame where pandas is
    # installed; the first import is a one-time cost of the process, timed
    # here so that it does not hide inside the first kneighbors below
    t0 = time.perf_counter()
    try:
        import pandas

        log(f"  import pandas {pandas.__version__}: {time.perf_counter() - t0:.3f} s")
    except ImportError:
        log("  pandas is not installed: results are dicts of numpy columns")
    t0 = time.perf_counter()
    sources = _build.all_sources()
    _build.build(sources)
    log(f"  built {sources} in {time.perf_counter() - t0:.2f} s")
    for src in sources:
        for line in _build.BUILD_LOG[src].splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"    {src}: {line.strip()}")

    log("phase 2: kernel vs twin on the card")
    phase_kernel_vs_twin(device, args.seed)

    log(f"phase 3: main path, {args.items} x {args.dim} items, {args.queries} queries, k={args.k}")
    main_out = phase_main_path(device, args)

    log("phase 4: persistence")
    phase_persistence(main_out)

    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [main_out["kernel"]]}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
