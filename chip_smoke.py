#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (spark_rapids_ml_torch) on one NVIDIA GPU.

Run from the root of a checkout:

    python3 chip_smoke.py [--seed 0] [--items 1000000] [--queries 10000]
                          [--dim 128] [--k 32] [--lr-rows 2000000] [--lr-dim 256]
                          [--lr-wide-rows 1000000] [--lr-wide-dim 3000]
                          [--lr-multi-rows 200000] [--pca-rows 1000000]
                          [--pca-dim 128] [--g-rows 200000]

Phases, each of which makes the script exit non-zero when it fails:

1. card: the GPU's name and power limit, the torch and CUDA versions, the
   build of every CUDA kernel of the port from the sources in the checkout
   (nvcc, one process per source, all started together) and its time, each
   kernel's registers, spills and shared memory (ptxas), and the tensor-core
   instructions in the built library's SASS (cuobjdump): the float32 kernel
   must hold HGMMA (wgmma), the float64 kernel DMMA;
2. kernels vs their plain versions, on the card: the split pass bit for
   bit; each main kernel against its plain version (both sides merged); the
   merge pass bit for bit in float32 and float64 at (S, k) = (5, 32),
   (8, 100) and (32, 1000), timed beside its plain version and torch.topk
   of the (q, S * k) view; the fused distance + top-k against its plain
   PyTorch twin at shapes with tails (k > valid items), invalid rows,
   exact ties (duplicated integer rows, also across the item splits),
   widths that are no multiple of the kernel's chunk (d = 17, 33, 131 and
   4100), k larger than a split's items, forced split counts, float32 and
   float64, and k = 1, 32 and 1000;
3. the main path at full size: NearestNeighbors(k).setIdCol("id").fit(items)
   -> kneighbors(queries) -> exactNearestNeighborsJoin, through the public
   entry points; every kernel's launch count is reset just before and read
   just after.  Then the result is held against the twin on the same
   staged tensors and against a float64 host recomputation, and each
   float32 kernel, its plain version and, where there is one, one library
   call computing the same function (a blocked torch.matmul + torch.topk,
   the yardstick) are timed with CUDA events, with the item sweep's split
   count swept;
4. the float64 path through the same entry points (float32_inputs=False) at
   a fifth of the items and queries, its launch counts (main kernel and
   merge) reset before and read after, held against the twin at float64
   precision and timed the same way, with the main kernel alone at one
   wave for k = 1, 32, 128; then the float64 function at the main shape
   (float64 items, 1 GB at 1M x 128), timed beside its bound and the
   library call, with the split count swept, and held against a float64
   host recomputation on 256 sampled queries;
5. LogisticRegression through the public entry points (no hand-written
   kernel: cuBLAS matrix-vector products and torch elementwise ops):
   (a) bench.py's headline, 2,000,000 x 256 float32 binomial from its
   `_gen_binary(seed=0)`, maxIter=50, regParam=1e-4, tol=1e-8; (b) the
   reference benchmark's width, 1,000,000 x 3000 float32, maxIter=200;
   (c) 200,000 x 256 float64, 5 classes, elasticNetParam=0.5,
   regParam=1e-3, sample weights.  Each cell: staging into a
   DeviceDataset, moments and standardize, the oracle per call by part
   beside its bytes bound and the memory a call adds, fits from the
   DeviceDataset (cold, least of three warm) and from host arrays
   (identical coefficients), iterations and oracle calls, a transform;
   held: the oracle's (f, g) against a float64 host recomputation (a
   65,536-row slice of (a) within 1e-5, (c) within 1e-12), the objective
   at the returned coefficients against a float64 host recomputation
   (1e-5 float32, 1e-10 float64), predictions against host margins, and
   (c) against the same fit on the CPU (coefficients 1e-6, objective
   1e-10);
6. PCA and LinearRegression through the public entry points (no
   hand-written kernel: cuBLAS products at IEEE float32, cuSOLVER eigh and
   QR, the host solve in float64): (d) PCA k=3 at bench.py's 1,000,000 x
   128 float32 (`_rng(1).standard_normal`), (e) PCA k=3 and (f)
   LinearRegression (OLS, ridge, elastic-net at the reference benchmark's
   settings, bench.py:1003-1012) on phase 5's (b) rows, 1,000,000 x 3000
   ((e) with three columns scaled by 16, 8 and 4 for a spectral gap),
   (g) float64, 200,000 x 256, sample weights, PCA k=10 and an
   elastic-net fit, on the card and on the CPU.  Each PCA cell: fits
   from a DeviceDataset (cold, least of three warm) with the statistics
   pass and the eigendecomposition timed apart, from numpy (the fused
   stage-and-solve pass and its prep/accumulate/overlap), (e) also the
   full solver forced and the fit from numpy with the fused pass off,
   a transform; held against a float64 eigendecomposition on the host of
   the covariance summed in float64 (principal-angle cosines and explained
   variance within 1e-4), and the fused route against the two-phase one.
   (f): the statistics pass, the host solve and the residual pass timed
   apart, the statistics of a 65,536-row slice within 1e-5 of a float64
   host recomputation, the coefficients of every fit within 1e-4 of the
   host solve of float64 statistics.  (g): the card's fits within 1e-9 of
   the CPU's.  Beside each device pass its bound, and per route
   max_memory_allocated;
7. persistence: the kNN model saved, loaded and asked again (identical
   results), and the LogisticRegression model of (a), the PCA model of
   (d) and the LinearRegression model of (f) likewise (identical
   transform outputs).

The last lines of standard output are a JSON object of the logistic
cells' numbers, one of the PCA and LinearRegression cells' numbers, a
JSON object of the kernels' numbers, the card's name and power limit,
and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
No JAX is imported.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

# Published dense peaks of one H100 SXM at its full 700 W (NVIDIA's data
# sheet): TF32 on the tensor cores, float32 outside them, float64 on the
# tensor cores (DMMA), and HBM.
_PEAK_TF32 = 495e12
_PEAK_FP32 = 67e12
_PEAK_FP64 = 67e12
_PEAK_BYTES_PER_S = 3.35e12
_SOURCE = "spark_rapids_ml_torch/ops/csrc/fused_knn.cu"
_REPLACES = "spark_rapids_ml_tpu/ops/pallas_knn.py:148"
# the kernels of fused_knn.cu, as their names appear in ptxas and SASS
_KERNELS = ("tf32_split_kernel", "fused_knn_tf32_kernel", "merge_partials_kernel",
            "merge_partials_regs_kernel", "fused_knn_f64_kernel")
# template arguments as the Itanium ABI mangles them
_TEMPLATE_ARGS = {"f": "float", "d": "double", "Lb1E": "true", "Lb0E": "false"}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warm: bool = True) -> float:
    """Mean device milliseconds of `fn` over `reps` runs (after one warm run
    unless `warm` is False)."""
    import torch

    if warm:
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 20) -> float:
    """Device milliseconds of one `fn` call: `reps` calls captured in one
    CUDA graph, replayed, so no host work sits between the launches (a
    short kernel timed by `cuda_ms` measures the host's wrapper too)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_ms(graph.replay, reps=3) / reps


def _kernel_of(symbol: str) -> str:
    """A kernel's name with its template arguments (`merge_partials_kernel
    <double, true>`) from its mangled symbol."""
    for name in _KERNELS:
        at = symbol.find(name)
        if at < 0:
            continue
        rest, args = symbol[at + len(name):], []
        if rest.startswith("I"):
            rest = rest[1:]
            while (tok := next((t for t in _TEMPLATE_ARGS if rest.startswith(t)), None)):
                args.append(_TEMPLATE_ARGS[tok])
                rest = rest[len(tok):]
        return f"{name}<{', '.join(args)}>" if args else name
    return symbol


def ptxas_report(text: str) -> dict:
    """Registers, spill bytes and static shared memory of each kernel, from
    nvcc's `-Xptxas -v` output."""
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = _kernel_of(m.group(1))
            out[cur] = {}
        elif cur is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                out[cur].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                out[cur]["registers"] = int(m.group(1))
                m = re.search(r"(\d+) bytes smem", line)
                out[cur]["static_smem"] = int(m.group(1)) if m else 0
    return out


def sass_counts(lib_path: Path, nvcc: str) -> dict:
    """Tensor-core instructions (HGMMA, HMMA, DMMA) in each kernel of a
    built library, from `cuobjdump -sass`."""
    exe = Path(nvcc).parent / "cuobjdump"
    sass = subprocess.run([str(exe), "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    out = {}
    for chunk in sass.split("Function : ")[1:]:
        name = _kernel_of(chunk.split(None, 1)[0])
        out[name] = {op: len(re.findall(rf"\b{op}\.", chunk)) for op in ("HGMMA", "HMMA", "DMMA")}
    return out


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


def phase2_cases(seed: int) -> list:
    """(name, items, valid, queries, k, dtype name, exact, splits) of phase
    2, as numpy arrays; splits None lets the wrapper choose."""
    rng = np.random.default_rng(seed)
    cases = []
    X = rng.normal(size=(3000, 40))
    v = np.ones(3000)
    v[-200:] = 0.0
    v[::7] = 0.0  # invalid rows inside the set, not only at the tail
    cases.append(("padded/invalid rows f32 k=32", X, v, rng.normal(size=(130, 40)), 32,
                  "float32", False, None))
    v = np.zeros(300)
    v[:4] = 1.0
    cases.append(("tails k>valid f32 k=7", rng.normal(size=(300, 6)), v,
                  rng.normal(size=(10, 6)), 7, "float32", False, None))
    Xi = rng.integers(-3, 4, size=(1000, 17)).astype(np.float64)
    Xi[500:] = Xi[:500]  # every row twice: exact ties broken by position
    Qi = rng.integers(-3, 4, size=(70, 17)).astype(np.float64)
    for dt in ("float32", "float64"):
        cases.append((f"exact ties {dt} k=32", Xi, np.ones(1000), Qi, 32, dt, True, None))
    # 4 splits of 256 items, each holding the same 256 integer rows: every
    # tie spans the split boundaries, and the lowest position must win
    Xs = np.tile(rng.integers(-3, 4, size=(256, 17)).astype(np.float64), (4, 1))
    Qs = rng.integers(-3, 4, size=(40, 17)).astype(np.float64)
    for dt in ("float32", "float64"):
        cases.append((f"exact ties across 4 item splits {dt} k=32", Xs, np.ones(1024), Qs, 32,
                      dt, True, 4))
    cases.append(("d=131 f32 k=1", rng.normal(size=(2000, 131)), np.ones(2000),
                  rng.normal(size=(65, 131)), 1, "float32", False, None))
    cases.append(("d=4100 f32 k=5", rng.normal(size=(300, 4100)), np.ones(300),
                  rng.normal(size=(9, 4100)), 5, "float32", False, None))
    cases.append(("f64 d=40 k=32", rng.normal(size=(3000, 40)), np.ones(3000),
                  rng.normal(size=(100, 40)), 32, "float64", False, None))
    X, Q = rng.normal(size=(3000, 40)), rng.normal(size=(100, 40))
    for s in (1, 3, 7):
        cases.append((f"f64 d=40 k=32 S={s}", X, np.ones(3000), Q, 32, "float64", False, s))
    for d in (17, 33, 131):
        cases.append((f"f64 d={d} k=32", rng.normal(size=(2000, d)), np.ones(2000),
                      rng.normal(size=(65, d)), 32, "float64", False, None))
    cases.append(("f64 d=4100 k=5", rng.normal(size=(300, 4100)), np.ones(300),
                  rng.normal(size=(9, 4100)), 5, "float64", False, None))

    # small integers plus multiples of 2^-30 need 32 significant bits:
    # float32 rounds the offsets away, so a float32 body misses 1e-10
    def beyond_f32(rows, cols):
        return (rng.integers(-3, 4, size=(rows, cols))
                + rng.integers(1, 256, size=(rows, cols)) * 2.0**-30)

    cases.append(("f64 beyond f32 precision k=16", beyond_f32(2000, 33), np.ones(2000),
                  beyond_f32(50, 33), 16, "float64", False, None))
    X, Q = rng.normal(size=(5000, 24)), rng.normal(size=(66, 24))
    for dt in ("float32", "float64"):
        cases.append((f"{dt} k=1000", X, np.ones(5000), Q, 1000, dt, False, None))
    # 7 splits of 768 items: k exceeds every split's item count
    for dt in ("float32", "float64"):
        cases.append((f"{dt} k=1000 > a split's 768 items", X, np.ones(5000), Q, 1000, dt,
                      False, 7))
    return cases


def hold_main_kernel(name, X, v, Q, k, splits, part_d, part_i, bq=256, bn=512) -> float:
    """Hold a main kernel's (q, S, k) partial lists against its plain
    version on the same inputs at `compare`'s tolerance for the type, after
    merging each side's lists: a split's list past the row's merged top-k
    depends on the order the blocks ran.  float32's plain version emulates
    3xTF32 with float32 matmuls on the split inputs; float64's takes IEEE
    float64 products."""
    import torch

    from spark_rapids_ml_torch.ops import fused_knn as fk

    if X.dtype == torch.float64:
        pd, pi = fk.fused_knn_f64_reference(X, fk.padded_item_norms(X, v), Q, k, splits,
                                            bq=bq, bn=bn)
    else:
        d_pad = fk.padded_width(X.shape[1])
        pd, pi = fk.fused_knn_tf32_reference(
            fk.tf32_split_reference(X, d_pad), fk.tf32_split_reference(Q, d_pad),
            fk.padded_item_norms(X, v), X.shape[0], k, splits, bq=bq, bn=bn)
    q2 = (Q * Q).sum(dim=1)
    return compare(f"{name} vs its plain version (merged)",
                   *fk.merge_partials_reference(part_d, part_i, q2, k),
                   *fk.merge_partials_reference(pd, pi, q2, k), exact=False)


def merge_bit_exact(device, rng, dtype, splits: int, k: int) -> None:
    """The merge pass on a main kernel's partial lists, with rows that tie
    across the lists, against its plain version bit for bit; and at this
    shape (40 rows) its time, its plain version's and that of torch.topk of
    the (q, S * k) view (the same selection without the tie order and the
    epilogue)."""
    import torch

    from spark_rapids_ml_torch.ops import fused_knn as fk

    n = max(3000, splits * 16 * 64)  # splits of 16 tiles or more
    X = rng.normal(size=(n, 24))
    X[n // 2:] = X[: n - n // 2]
    X, Q = (torch.as_tensor(a, dtype=dtype, device=device) for a in (X, rng.normal(size=(40, 24))))
    v = torch.ones(n, dtype=dtype, device=device)
    if dtype == torch.float64:
        part_d, part_i = fk.fused_knn_f64(X, Q, fk.padded_item_norms(X, v), k, splits)
    else:
        part_d, part_i = fk.topk_partials(X, v, Q, k, splits)
    q2 = (Q * Q).sum(dim=1)
    kd, ki = fk.merge_partials(part_d, part_i, q2, k)
    td, ti = fk.merge_partials_reference(part_d, part_i, q2, k)
    same = torch.equal(kd, td) and torch.equal(ki, ti)
    call_ms = cuda_ms(lambda: fk.merge_partials(part_d, part_i, q2, k), reps=10)
    device_ms = graph_ms(lambda: fk.merge_partials(part_d, part_i, q2, k), reps=10)
    plain_ms = cuda_ms(lambda: fk.merge_partials_reference(part_d, part_i, q2, k), reps=3)
    flat = part_d.view(part_d.shape[0], -1)
    library_ms = cuda_ms(lambda: torch.topk(flat, k, dim=1, largest=False), reps=10)
    library_device_ms = graph_ms(lambda: torch.topk(flat, k, dim=1, largest=False), reps=10)
    log(f"  merge pass {str(dtype)[6:]} (S, k) = ({part_d.shape[1]}, {k}), {Q.shape[0]} rows: "
        f"bit-exact against its plain version: {same}; {call_ms:.4f} ms a call, "
        f"{device_ms:.4f} ms on the card (CUDA graph); plain {plain_ms:.4f} ms; torch.topk of "
        f"the (q, S*k) view {library_ms:.4f} a call, {library_device_ms:.4f} in a graph")
    if not same:
        raise AssertionError(f"merge_partials differs from merge_partials_reference, {dtype}")


def phase_kernels_vs_plain(device, seed: int) -> None:
    import torch

    from spark_rapids_ml_torch.ops import fused_knn as fk

    rng = np.random.default_rng(seed + 2)
    for d in (6, 17, 131):
        X = torch.as_tensor(rng.normal(size=(777, d)), dtype=torch.float32, device=device)
        d_pad = fk.padded_width(d)
        same = torch.equal(fk.tf32_split(X, d_pad), fk.tf32_split_reference(X, d_pad))
        log(f"  split pass d={d} (d_pad {d_pad}): bit-exact against its plain version: {same}")
        if not same:
            raise AssertionError(f"tf32_split differs from tf32_split_reference at d={d}")
    v = torch.ones(3000, dtype=torch.float32, device=device)
    X, Q = (torch.as_tensor(rng.normal(size=size), dtype=torch.float32, device=device)
            for size in ((3000, 40), (130, 40)))
    part_d, part_i = fk.topk_partials(X, v, Q, 32, splits=5)
    hold_main_kernel("main kernel, 5 item splits", X, v, Q, 32, 5, part_d, part_i)
    valid = np.ones(3000)
    valid[::7] = 0.0
    X, Q, v = (torch.as_tensor(a, dtype=torch.float64, device=device)
               for a in (rng.normal(size=(3000, 40)), rng.normal(size=(130, 40)), valid))
    for splits in (1, 5):
        part_d, part_i = fk.fused_knn_f64(X, Q, fk.padded_item_norms(X, v), 32, splits)
        hold_main_kernel(f"float64 main kernel, {splits} item splits", X, v, Q, 32, splits,
                         part_d, part_i)
    # the merge pass on lists with ties across them (exact in the main
    # kernels; another summation order may break them by an ulp, so the main
    # kernels are held on the data above)
    for dtype in (torch.float32, torch.float64):
        for splits, k in ((5, 32), (8, 100), (32, 1000)):
            merge_bit_exact(device, rng, dtype, splits, k)

    f32_before, f64_before = fk.LAUNCHES, fk.LAUNCHES_F64
    cases = phase2_cases(seed)
    for name, X, v, Q, k, dt, exact, splits in cases:
        dt = getattr(torch, dt)
        Xt = torch.as_tensor(X, dtype=dt, device=device).contiguous()
        vt = torch.as_tensor(v, dtype=dt, device=device)
        Qt = torch.as_tensor(Q, dtype=dt, device=device).contiguous()
        kd, ki = fk.fused_topk_sqdist(Xt, vt, Qt, k, splits=splits)
        td, ti = fk.fused_topk_sqdist_reference(Xt, vt, Qt, k)
        torch.cuda.synchronize()
        compare(name, kd, ki, td, ti, exact)
    n64 = sum(c[5] == "float64" for c in cases)
    if (fk.LAUNCHES - f32_before, fk.LAUNCHES_F64 - f64_before) != (len(cases) - n64, n64):
        raise AssertionError(f"{len(cases) - n64} float32 and {n64} float64 cases launched "
                             f"{fk.LAUNCHES - f32_before} and {fk.LAUNCHES_F64 - f64_before} times")


def reset_counts() -> None:
    from spark_rapids_ml_torch.ops import fused_knn as fk

    fk.LAUNCHES = fk.LAUNCHES_F64 = fk.SPLIT_LAUNCHES = fk.MERGE_LAUNCHES = 0


def library_topk(items_t, queries_t, k: int):
    """The yardstick: one blocked torch.matmul + torch.topk computing the
    same function (1024 queries a block), IEEE arithmetic."""
    import torch

    x2 = (items_t * items_t).sum(1)
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for q0 in range(0, queries_t.shape[0], 1024):
            Qb = queries_t[q0 : q0 + 1024]
            d2 = (Qb * Qb).sum(1, keepdim=True) - 2.0 * (Qb @ items_t.T) + x2
            torch.topk(d2, k, dim=1, largest=False)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def bound(flops: float, peak_flops: float, nbytes: float):
    """(least ms the card could take, what bounds it)."""
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / _PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def merge_entry(part_d, part_i, q2, k: int, launches: int) -> dict:
    """The merge pass on these partial lists: timed, held bit for bit
    against its plain version, beside its bytes bound and torch.topk of the
    (q, S * k) view (the same selection without the tie order and the
    epilogue).  `ms` and `library_ms` are a call from Python (CUDA events,
    the host's wrapper included, as every other entry); `device_ms` is one
    call inside a CUDA graph, the kernel's own time on the card."""
    import torch

    from spark_rapids_ml_torch.ops import fused_knn as fk

    q, s, _ = part_d.shape
    ms = cuda_ms(lambda: fk.merge_partials(part_d, part_i, q2, k), reps=20)
    device_ms = graph_ms(lambda: fk.merge_partials(part_d, part_i, q2, k))
    plain_ms = cuda_ms(lambda: fk.merge_partials_reference(part_d, part_i, q2, k), reps=2)
    flat = part_d.view(q, s * k)
    library_ms = cuda_ms(lambda: torch.topk(flat, k, dim=1, largest=False), reps=20)
    library_device_ms = graph_ms(lambda: torch.topk(flat, k, dim=1, largest=False))
    md, mi = fk.merge_partials(part_d, part_i, q2, k)
    rd, ri = fk.merge_partials_reference(part_d, part_i, q2, k)
    if not (torch.equal(mi, ri) and torch.equal(md, rd)):
        raise AssertionError(f"merge pass differs from its plain version, {part_d.dtype}")
    size = part_d.element_size()
    nbytes = (size + 4.0) * part_d.numel() + size * q + (size + 4.0) * q * k
    bound_ms, bound_by = bound(0.0, _PEAK_FP32, nbytes)
    dt = str(part_d.dtype)[6:]
    log(f"  merge pass {dt}, {q} rows x {s} lists x k={k}: {ms:.4f} ms a call from Python, "
        f"{device_ms:.4f} ms on the card (CUDA graph); plain {plain_ms:.3f}; torch.topk of the "
        f"(q, S*k) view {library_ms:.4f} a call, {library_device_ms:.4f} in a graph; bound "
        f"{bound_ms:.4f} ms ({bound_by}), share {bound_ms / ms:.1%} of a call, "
        f"{bound_ms / device_ms:.1%} of the device time")
    return entry(f"merge_partials<{dt}>", launches, 0.0, ms, plain_ms, bound_ms, bound_by,
                 library_ms, f"{q} rows x {s} lists x k={k}, {dt}; device_ms is one call "
                 "inside a CUDA graph", device_ms=device_ms)


def entry(name, launches, err, ms, plain_ms, bound_ms, bound_by, library_ms, shape, **more):
    return {"name": name, "route": "cuda", "source": _SOURCE, "replaces": _REPLACES,
            "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
            "shape": shape, **more}


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

    reset_counts()
    t0 = time.perf_counter()
    model = NearestNeighbors(k=k).setIdCol("id").fit({"features": items, "id": item_ids})
    t_fit = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, _, knn_df = model.kneighbors({"features": queries, "id": query_ids})
    t_kn = time.perf_counter() - t0
    t0 = time.perf_counter()
    join = model.exactNearestNeighborsJoin({"features": queries, "id": query_ids})
    t_join = time.perf_counter() - t0
    launches = {"main": fk.LAUNCHES, "split": fk.SPLIT_LAUNCHES, "merge": fk.MERGE_LAUNCHES}
    decision = dict(LAST_KERNEL_DECISION)
    log(f"  fit {t_fit:.3f} s; kneighbors {t_kn:.3f} s (items staged, {q / t_kn:.1f} queries/s); "
        f"join {t_join:.3f} s (items resident, {q / t_join:.1f} queries/s)")
    log(f"  launches on the main path: {launches}; LAST_KERNEL_DECISION {decision}")
    if decision["kernel"] != "fused_knn_tf32" or min(launches.values()) < 1:
        raise AssertionError("the main path did not run the float32 CUDA kernels")

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

    # ---- the whole float32 function: split, main kernel, merge -----------
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    splits = fk.auto_splits(n, q, k, sms)
    ms = cuda_ms(lambda: fk.fused_topk_sqdist(items_t, valid_t, queries_t, k), reps=5)
    plain_ms = cuda_ms(
        lambda: fk.fused_topk_sqdist_reference(items_t, valid_t, queries_t, k, bq=1024, bn=8192),
        reps=1,
    )
    library_ms = cuda_ms(lambda: library_topk(items_t, queries_t, k), reps=2)
    flops = 2.0 * q * n * d
    nbytes = 4.0 * (n * d + q * d + 2 * n) + 8.0 * q * k  # inputs once, outputs once
    bound_ms, bound_by = bound(3 * flops, _PEAK_TF32, nbytes)
    fp32_ms, _ = bound(flops, _PEAK_FP32, nbytes)
    log(f"  fused_topk_sqdist {ms:.3f} ms ({q / ms * 1e3:.1f} queries/s, "
        f"{flops / ms / 1e9:.2f} TFLOP/s at 2qnd); twin {plain_ms:.3f} ms; "
        f"library matmul+topk {library_ms:.3f} ms")
    log(f"  bound at 3xTF32 (3 * 2qnd / {_PEAK_TF32 / 1e12:.0f} TFLOP/s): {bound_ms:.3f} ms "
        f"({bound_by}), share {bound_ms / ms:.1%}; bound of the first design, FP32 outside the "
        f"tensor cores (2qnd / {_PEAK_FP32 / 1e12:.0f} TFLOP/s): {fp32_ms:.3f} ms, the kernel "
        f"taking {ms / fp32_ms:.2f}x of it")

    # ---- its parts, each at the main path's shapes ------------------------
    d_pad = fk.padded_width(d)
    xsplit, qsplit = fk.tf32_split(items_t, d_pad), fk.tf32_split(queries_t, d_pad)
    xs = fk.padded_item_norms(items_t, valid_t)
    split_ms = cuda_ms(lambda: fk.tf32_split(items_t, d_pad), reps=5)
    split_plain_ms = cuda_ms(lambda: fk.tf32_split_reference(items_t, d_pad), reps=2)
    split_err = float((xsplit - fk.tf32_split_reference(items_t, d_pad)).abs().max())
    qsplit_ms = cuda_ms(lambda: fk.tf32_split(queries_t, d_pad), reps=5)
    main_ms = cuda_ms(lambda: fk.fused_knn_tf32(xsplit, qsplit, xs, n, k, splits), reps=5)
    part_d, part_i = fk.fused_knn_tf32(xsplit, qsplit, xs, n, k, splits)
    hold_main_kernel("main kernel at the main shape", items_t, valid_t, queries_t, k, splits,
                     part_d, part_i, bq=1024, bn=8192)
    q2 = (queries_t * queries_t).sum(dim=1)
    merge = merge_entry(part_d, part_i, q2, k, launches["merge"])
    norms_ms = cuda_ms(lambda: fk.padded_item_norms(items_t, valid_t), reps=5)
    log(f"  parts (S = {splits} item splits): item norms {norms_ms:.3f} ms, split items "
        f"{split_ms:.3f} ms (plain {split_plain_ms:.3f}), split queries {qsplit_ms:.3f} ms, "
        f"main kernel {main_ms:.3f} ms, merge {merge['ms']:.4f} ms a call "
        f"({merge['device_ms']:.4f} on the card)")
    sweep = {}
    for s in sorted({1, 2, 4, 6, 8, 12, 16, 24, splits}):
        sweep[s] = cuda_ms(lambda: fk.fused_topk_sqdist(items_t, valid_t, queries_t, k, splits=s),
                           reps=3)
    log("  split sweep (fused_topk_sqdist ms by S): "
        + ", ".join(f"{s}: {t:.3f}" for s, t in sweep.items()))
    # one wave of 120 blocks (20 query blocks x 6 splits): a block's time
    # beside a sixth of the 1-split time shows the cost every block pays
    q1 = min(q, 2560)
    qsplit1 = qsplit[:, :q1].contiguous()
    per_k = {kk: (cuda_ms(lambda: fk.fused_knn_tf32(xsplit, qsplit1, xs, n, kk, 1), 2),
                  cuda_ms(lambda: fk.fused_knn_tf32(xsplit, qsplit1, xs, n, kk, 6), 3))
             for kk in (1, k, 128)}
    log(f"  main kernel alone, {q1} queries, ms with 1 and 6 item splits by k: "
        + ", ".join(f"k={kk}: {a:.3f} / {b:.3f}" for kk, (a, b) in per_k.items()))

    split_bytes = 4.0 * n * d + 8.0 * n * d_pad
    shape = f"{n}x{d} float32 items, {q} queries, k={k}"
    kernels = [
        entry("fused_knn_tf32", launches["main"], err, ms, plain_ms, bound_ms, bound_by,
              library_ms, shape + f", S={splits}; ms is the whole fused_topk_sqdist call"),
        entry("tf32_split", launches["split"], split_err, split_ms, split_plain_ms,
              *bound(0.0, _PEAK_FP32, split_bytes), None, f"{n}x{d} float32 items"),
        merge,
    ]
    return {"model": model, "queries": queries, "query_ids": query_ids, "knn_df": knn_df,
            "kernels": kernels}


def phase_float64_path(device, args) -> list:
    import torch

    from spark_rapids_ml_torch.knn import NearestNeighbors
    from spark_rapids_ml_torch.ops import fused_knn as fk
    from spark_rapids_ml_torch.ops.knn import LAST_KERNEL_DECISION

    n, q, d, k = max(1, args.items // 5), max(1, args.queries // 5), args.dim, args.k
    rng = np.random.default_rng(args.seed + 3)
    items, queries = rng.standard_normal(size=(n, d)), rng.standard_normal(size=(q, d))
    reset_counts()
    t0 = time.perf_counter()
    model = NearestNeighbors(k=k, float32_inputs=False).fit(items)
    _, _, knn_df = model.kneighbors(queries)
    t_kn = time.perf_counter() - t0
    launches = {"main": fk.LAUNCHES_F64, "merge": fk.MERGE_LAUNCHES}
    decision = dict(LAST_KERNEL_DECISION)
    log(f"  fit + kneighbors {t_kn:.3f} s ({q / t_kn:.1f} queries/s); launches {launches}; "
        f"LAST_KERNEL_DECISION {decision}")
    if decision["kernel"] != "fused_knn_f64" or min(launches.values()) < 1:
        raise AssertionError("the float64 path did not run the float64 CUDA kernels")
    items_t, valid_t, _ = model._device_items[1]
    queries_t = torch.as_tensor(queries, device=device)
    kd, kp = fk.fused_topk_sqdist(items_t, valid_t, queries_t, k)
    td, tp = fk.fused_topk_sqdist_reference(items_t, valid_t, queries_t, k, bq=1024, bn=8192)
    err = compare("float64 path: kernel vs twin", kd, kp, td, tp, exact=False)
    if not np.array_equal(np.stack(knn_df["indices"]), kp.cpu().numpy()):
        raise AssertionError("float64 kneighbors differs from a direct kernel call")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    ms = cuda_ms(lambda: fk.fused_topk_sqdist(items_t, valid_t, queries_t, k), reps=3)
    plain_ms = cuda_ms(
        lambda: fk.fused_topk_sqdist_reference(items_t, valid_t, queries_t, k, bq=1024, bn=8192),
        reps=1,
    )
    library_ms = cuda_ms(lambda: library_topk(items_t, queries_t, k), reps=2)
    bound_ms, bound_by = bound(2.0 * q * n * d, _PEAK_FP64,
                               8.0 * (n * d + q * d + 2 * n) + 12.0 * q * k)
    log(f"  fused_knn_f64 {ms:.3f} ms (S = {fk.auto_splits(n, q, k, sms, torch.float64)}); twin "
        f"{plain_ms:.3f} ms; library matmul+topk {library_ms:.3f} ms; bound {bound_ms:.3f} ms "
        f"({bound_by}, FP64 on the tensor cores), share {bound_ms / ms:.1%}")
    # one wave of 128 blocks (16 query blocks x 8 splits): a block's time
    # beside an eighth of the 1-split time shows the cost every block pays
    xs = fk.padded_item_norms(items_t, valid_t)
    per_k = {kk: (cuda_ms(lambda: fk.fused_knn_f64(items_t, queries_t, xs, kk, 1), 2),
                  cuda_ms(lambda: fk.fused_knn_f64(items_t, queries_t, xs, kk, 8), 3))
             for kk in (1, k, 128)}
    log(f"  float64 main kernel alone, {q} queries, ms with 1 and 8 item splits by k: "
        + ", ".join(f"k={kk}: {a:.3f} / {b:.3f}" for kk, (a, b) in per_k.items()))
    kernels = [entry("fused_knn_f64", launches["main"], err, ms, plain_ms, bound_ms, bound_by,
                     library_ms, f"{n}x{d} float64 items, {q} queries, k={k}; ms is the whole "
                     f"fused_topk_sqdist call (main kernel + merge)")]

    # ---- the float64 function at the main shape ---------------------------
    n, q = args.items, args.queries
    gen = torch.Generator(device=device).manual_seed(args.seed + 5)
    items_t = torch.randn((n, d), dtype=torch.float64, device=device, generator=gen)
    queries_t = torch.randn((q, d), dtype=torch.float64, device=device, generator=gen)
    valid_t = torch.ones(n, dtype=torch.float64, device=device)
    splits = fk.auto_splits(n, q, k, sms, torch.float64)
    ms = cuda_ms(lambda: fk.fused_topk_sqdist(items_t, valid_t, queries_t, k), reps=3)
    library_ms = cuda_ms(lambda: library_topk(items_t, queries_t, k), reps=1)
    plain_ms = cuda_ms(
        lambda: fk.fused_topk_sqdist_reference(items_t, valid_t, queries_t, k, bq=1024, bn=8192),
        reps=1, warm=False,
    )
    bound_ms, bound_by = bound(2.0 * q * n * d, _PEAK_FP64,
                               8.0 * (n * d + q * d + 2 * n) + 12.0 * q * k)
    log(f"  main shape {n} x {d} float64 items, {q} queries, k={k}: fused_knn_f64 {ms:.3f} ms "
        f"(S = {splits}); library matmul+topk {library_ms:.3f} ms; twin {plain_ms:.3f} ms; "
        f"bound {bound_ms:.3f} ms ({bound_by}, 2qnd / {_PEAK_FP64 / 1e12:.0f} TFLOP/s), share "
        f"{bound_ms / ms:.1%}")
    kd, kp = fk.fused_topk_sqdist(items_t, valid_t, queries_t, k)
    sample = torch.as_tensor(np.random.default_rng(args.seed + 6).choice(q, size=min(256, q),
                                                                         replace=False),
                             device=device)
    kd_h, kp_h = kd[sample].cpu().numpy(), kp[sample].cpu().numpy()
    near = items_t[kp[sample].long()].cpu().numpy()
    exact = ((near - queries_t[sample].cpu().numpy()[:, None, :]) ** 2).sum(-1)
    rel = float((np.abs(kd_h - exact) / np.maximum(exact, 1e-30)).max())
    log(f"  float64 host recomputation on {len(sample)} queries: max relative |d2 error| = "
        f"{rel:.3e}")
    if not (kp_h >= 0).all() or rel > 1e-10:
        raise AssertionError("float64 d2 differs from the float64 recomputation beyond 1e-10")
    sweep = {}
    for s in sorted({1, 2, 4, 8, 16, splits}):
        sweep[s] = cuda_ms(lambda: fk.fused_topk_sqdist(items_t, valid_t, queries_t, k, splits=s),
                           reps=2)
    log("  split sweep (float64 fused_topk_sqdist ms by S): "
        + ", ".join(f"{s}: {t:.3f}" for s, t in sweep.items()))
    shape = f"{n}x{d} float64 items, {q} queries, k={k}"
    kernels.append(entry("fused_knn_f64", launches["main"], rel, ms, plain_ms, bound_ms, bound_by,
                         library_ms, shape + f", S={splits}; ms is the whole fused_topk_sqdist "
                         "call; max_abs_err is the relative d2 error against a float64 host "
                         "recomputation"))

    # ---- the merge pass on float64 lists at the main shape -----------------
    part_d, part_i = fk.fused_knn_f64(items_t, queries_t, fk.padded_item_norms(items_t, valid_t),
                                      k, splits)
    q2 = (queries_t * queries_t).sum(dim=1)
    kernels.append(merge_entry(part_d, part_i, q2, k, launches["merge"]))
    return kernels


# ---- LogisticRegression ------------------------------------------------------


def gen_binary(n_rows: int, n_cols: int, seed: int = 0):
    """bench.py's `_gen_binary`: standard normal float32 features, labels
    from a random linear model plus noise."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n_rows, n_cols), dtype=np.float32)
    true_w = rng.standard_normal((n_cols,)).astype(np.float32)
    logits = X @ true_w + 0.25 * rng.standard_normal(n_rows).astype(np.float32)
    return X, (logits > 0).astype(np.float32)


def gen_multiclass(n_rows: int, n_cols: int, classes: int, seed: int):
    """float64 features, labels the argmax of `classes` noisy linear
    scores, sample weights in [0.2, 2)."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n_rows, n_cols))
    W = rng.standard_normal((classes, n_cols)) * (3.0 / np.sqrt(n_cols))
    y = np.argmax(X @ W.T + rng.gumbel(size=(n_rows, classes)), axis=1).astype(np.float64)
    return X, y, rng.uniform(0.2, 2.0, n_rows)


def _host_rows(X, chunk: int = 1 << 16):
    for lo in range(0, X.shape[0], chunk):
        yield slice(lo, min(lo + chunk, X.shape[0]))


def host_moments(X, w):
    """Weighted mean and ddof-1 std of X's columns in float64 on the host,
    two passes over row chunks (std 0 -> 1, as the estimator does)."""
    wsum = w.sum()
    mean = sum(w[r] @ X[r].astype(np.float64) for r in _host_rows(X)) / wsum
    var = sum(w[r] @ (X[r].astype(np.float64) - mean) ** 2 for r in _host_rows(X))
    std = np.sqrt(var / max(wsum - 1.0, 1.0))
    return mean, np.where(std == 0.0, 1.0, std)


def host_objective(X, y, w, coef, intercept, l2: float, l1: float, std=None,
                   with_grad: bool = False):
    """The Spark logistic objective (data loss + penalty) in float64 on the
    host, over row chunks: binomial when coef has one row.  `std` given,
    the penalty is on coef * std (the standardized coefficients).  With
    `with_grad`, also the gradient in the oracle's theta layout."""
    coef = np.asarray(coef, np.float64)
    intercept = np.asarray(intercept, np.float64)
    binomial = coef.shape[0] == 1
    wsum, loss = w.sum(), 0.0
    g_coef, g_b = np.zeros_like(coef), np.zeros(coef.shape[0])
    for r in _host_rows(X):
        x = X[r].astype(np.float64)
        m = x @ coef.T + intercept
        wr = w[r] / wsum
        if binomial:
            s = 2.0 * y[r] - 1.0
            z = -s * m[:, 0]
            loss += (np.logaddexp(0.0, z) * wr).sum()
            res = (-s / (1.0 + np.exp(-z)) * wr)[:, None]
        else:
            lse = np.logaddexp.reduce(m, axis=1)
            lab = y[r].astype(np.int64)
            loss += ((lse - m[np.arange(len(lab)), lab]) * wr).sum()
            res = np.exp(m - lse[:, None])
            res[np.arange(len(lab)), lab] -= 1.0
            res *= wr[:, None]
        if with_grad:
            g_coef += res.T @ x
            g_b += res.sum(0)
    pen = coef * (std if std is not None else 1.0)
    f = loss + 0.5 * l2 * (pen * pen).sum() + l1 * np.abs(pen).sum()
    if not with_grad:
        return f
    return f, np.concatenate([(g_coef + l2 * coef).ravel(), g_b])


def check_oracle(name, X, y, w, classes: int, l2: float, rtol: float, device, seed: int) -> float:
    """The oracle's (f, g) on the card at theta = 0 and at a seeded random
    theta against a float64 recomputation on the host; the largest relative
    error (f relative to |f|, g to max |g|)."""
    import torch

    from spark_rapids_ml_torch.ops import logistic as lo

    binomial = classes == 2
    dt = torch.float64 if X.dtype == np.float64 else torch.float32
    oracle = lo.LogisticOracle(torch.as_tensor(X, dtype=dt, device=device),
                               torch.as_tensor(w, dtype=dt, device=device),
                               torch.as_tensor(y.astype(np.int32), device=device),
                               classes, l2, True, binomial)
    C, d = oracle.C, X.shape[1]
    worst = 0.0
    for theta in (np.zeros(oracle.n_param),
                  np.random.default_rng(seed).normal(size=oracle.n_param) / np.sqrt(d)):
        f, g = oracle(theta)
        hf, hg = host_objective(X, y, w, theta[: C * d].reshape(C, d), theta[C * d:], l2, 0.0,
                                with_grad=True)
        err = max(abs(f - hf) / abs(hf), float(np.abs(g - hg).max() / np.abs(hg).max()))
        worst = max(worst, err)
    log(f"  {name}: oracle (f, g) on the card vs a float64 host recomputation at theta = 0 "
        f"and a random theta: max relative error {worst:.3e} (limit {rtol:g})")
    if worst > rtol:
        raise AssertionError(f"{name}: the oracle differs from the host beyond {rtol:g}")
    return worst


def oracle_parts(X, w, y, classes: int, l2: float, device) -> dict:
    """ms per oracle call on the card by part (CUDA events): the margin
    matmul, the elementwise loss and residual, the gradient matmul, the
    whole evaluation on the device, and a call from the solver (theta up,
    (f, g) down); and the memory one call adds beside X."""
    import torch

    from spark_rapids_ml_torch.ops import logistic as lo

    oracle = lo.LogisticOracle(X, w, y, classes, l2, True, classes == 2)
    theta_h = np.random.default_rng(7).normal(size=oracle.n_param) / np.sqrt(X.shape[1])
    theta = torch.as_tensor(theta_h, dtype=X.dtype, device=device)
    m = oracle.margins(theta)
    _, r = oracle.loss_and_residual(m)
    out = {
        "margin_ms": cuda_ms(lambda: oracle.margins(theta), reps=10),
        "elementwise_ms": cuda_ms(lambda: oracle.loss_and_residual(m), reps=10),
        "gradient_ms": cuda_ms(lambda: oracle.gradient(r), reps=10),
        "device_ms": cuda_ms(lambda: oracle.value_and_grad(theta), reps=10),
    }
    oracle(theta_h)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        oracle(theta_h)
    out["call_ms"] = (time.perf_counter() - t0) / 10 * 1e3
    del m, r
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    oracle(theta_h)
    out["call_extra_bytes"] = torch.cuda.max_memory_allocated(device) - base
    n, d = X.shape
    if out["call_extra_bytes"] > max(16 * n * oracle.C * X.element_size(), 1 << 20):
        raise AssertionError(f"one oracle call allocated {out['call_extra_bytes']} bytes: more "
                             f"than N and N x C vectors (N = {n}, C = {oracle.C})")
    out["bound_ms"] = 2.0 * n * d * X.element_size() / _PEAK_BYTES_PER_S * 1e3
    return out


def device_busy_share(fn) -> tuple:
    """(wall ms of one `fn()` call, the share of it the card spent in
    kernels) from a torch.profiler trace of the call; the share is None
    when the trace holds no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # the kernels' own entries: a CPU op's entry counts its kernels' time too
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA)
    return wall_ms, (busy_us / 1e3 / wall_ms if busy_us > 0 else None)


def phase_logistic_cell(device, name: str, X, y, w, classes: int, fit_kw: dict,
                        transform_rows: int, seed: int, weight_col: bool) -> dict:
    """One LogisticRegression cell through the public entry points: fits
    from a DeviceDataset (cold, then the least of three warm) and from host
    arrays, the layers timed apart, the oracle and the objective held
    against float64 host recomputations, and a transform."""
    import torch

    from spark_rapids_ml_torch import DeviceDataset
    from spark_rapids_ml_torch.classification import LogisticRegression
    from spark_rapids_ml_torch.ops import logistic as lo
    from spark_rapids_ml_torch.ops import stats

    n, d = X.shape
    f32 = X.dtype == np.float32
    dtype = np.float32 if f32 else np.float64
    reg, en = fit_kw.get("regParam", 0.0), fit_kw.get("elasticNetParam", 0.0)
    l2, l1 = reg * (1.0 - en), reg * en
    rec = {"cell": name, "rows": n, "cols": d, "classes": classes, "dtype": np.dtype(dtype).name}

    # staging: host rows -> a DeviceDataset
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ds = DeviceDataset.from_host(X, y=y, weight=w if weight_col else None, dtype=dtype,
                                 label_dtype=np.int32)
    torch.cuda.synchronize()
    rec["staging_s"] = time.perf_counter() - t0
    rec["staging_GBps"] = X.nbytes / rec["staging_s"] / 1e9
    mean, std, _ = stats.weighted_moments(ds.X, ds.weight)
    rec["moments_ms"] = cuda_ms(lambda: stats.weighted_moments(ds.X, ds.weight), reps=3)
    rec["standardize_ms"] = cuda_ms(lambda: stats.standardize(ds.X, ds.weight, mean, std),
                                    reps=2)
    Xs = stats.standardize(ds.X, ds.weight, mean, std)
    rec["oracle"] = oracle_parts(Xs, ds.weight, ds.y, classes, l2, device)
    del Xs
    o = rec["oracle"]
    log(f"  {name}: staging {rec['staging_s']:.3f} s ({rec['staging_GBps']:.2f} GB/s); moments "
        f"{rec['moments_ms']:.3f} ms; standardize {rec['standardize_ms']:.3f} ms")
    log(f"  {name}: oracle per call on the card: margin matmul {o['margin_ms']:.3f} ms, "
        f"elementwise {o['elementwise_ms']:.3f} ms, gradient matmul {o['gradient_ms']:.3f} ms, "
        f"whole evaluation {o['device_ms']:.3f} ms (bytes bound, X read twice: "
        f"{o['bound_ms']:.3f} ms, share {o['bound_ms'] / o['device_ms']:.1%}); a call from the "
        f"solver {o['call_ms']:.3f} ms; memory a call adds {o['call_extra_bytes'] / 1e6:.1f} MB")

    def fit(data):
        est = LogisticRegression(**fit_kw)
        if weight_col and not isinstance(data, DeviceDataset):
            est.setWeightCol("wt")
        lo.ORACLE_CALLS = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = est.fit(data)
        return time.perf_counter() - t0, model, lo.ORACLE_CALLS

    torch.cuda.reset_peak_memory_stats(device)
    rec["fit_cold_s"], model, calls = fit(ds)
    warm = [fit(ds) for _ in range(3)]
    rec["fit_warm_s"] = min(t for t, _, _ in warm)
    rec["rows_per_s"] = n / rec["fit_warm_s"]
    rec["iterations"], rec["oracle_calls"] = model.summary.totalIterations, calls
    if any(c != calls or m.summary.totalIterations != rec["iterations"] for _, m, c in warm):
        raise AssertionError(f"{name}: warm fits took another path than the cold one")
    host_data = {"features": X, "label": y, "wt": w} if weight_col else (X, y)
    rec["fit_numpy_s"], model_np, _ = fit(host_data)
    if not (np.array_equal(model_np.coef_, model.coef_)
            and np.array_equal(model_np.intercept_, model.intercept_)):
        raise AssertionError(f"{name}: the fit from host arrays differs from the DeviceDataset fit")
    rec["max_memory_allocated_GB"] = torch.cuda.max_memory_allocated(device) / 1e9
    wall_ms, rec["device_busy_share"] = device_busy_share(lambda: fit(ds))
    log(f"  {name}: one warm fit under torch.profiler: {wall_ms:.3f} ms, the card busy in "
        f"kernels for {rec['device_busy_share'] or float('nan'):.1%} of it")
    prologue = (rec["moments_ms"] + rec["standardize_ms"]) / 1e3
    rec["host_ms_per_iter"] = ((rec["fit_warm_s"] - prologue - calls * o["device_ms"] / 1e3)
                               / max(rec["iterations"], 1) * 1e3)
    log(f"  {name}: fit from a DeviceDataset cold {rec['fit_cold_s']:.3f} s, warm "
        f"{rec['fit_warm_s']:.3f} s ({rec['rows_per_s']:,.0f} rows/s); from host arrays "
        f"{rec['fit_numpy_s']:.3f} s; {rec['iterations']} iterations, {calls} oracle calls; "
        f"the rest of a warm fit per iteration (solver, D2H of f and g, launches): "
        f"{rec['host_ms_per_iter']:.3f} ms; max_memory_allocated "
        f"{rec['max_memory_allocated_GB']:.2f} GB")

    # the objective at the returned coefficients, recomputed on the host
    h_mean, h_std = host_moments(X, w if weight_col else np.ones(n))
    obj = host_objective(X, y, w if weight_col else np.ones(n), model.coef_, model.intercept_,
                         l2, l1, std=h_std)
    obj = float(obj)
    rec["objective"], rec["objective_host"] = model.objective, obj
    rel = abs(model.objective - obj) / abs(obj)
    limit = 1e-5 if f32 else 1e-10
    log(f"  {name}: model.objective {model.objective!r}, float64 host recomputation {obj!r}, "
        f"relative error {rel:.3e} (limit {limit:g})")
    if not np.isfinite(model.coef_).all() or model.coef_.shape != (1 if classes == 2 else classes,
                                                                     d) or rel > limit:
        raise AssertionError(f"{name}: the model's objective differs from the host's")

    # transform
    rows = min(transform_rows, n)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = model.transform(X[:rows])
    t_tr = time.perf_counter() - t0
    rec["transform_rows"], rec["transform_rows_per_s"] = rows, rows / t_tr
    probs = out["probability"]
    coef64, b64 = model.coef_.astype(np.float64), model.intercept_.astype(np.float64)
    host_pred = np.concatenate([
        (lambda m: m[:, 0] > 0 if classes == 2 else np.argmax(m, axis=1))(
            X[r].astype(np.float64) @ coef64.T + b64) for r in _host_rows(X[:rows])])
    agree = float((out["prediction"] == host_pred).mean())
    log(f"  {name}: transform {rows} rows {t_tr:.3f} s ({rec['transform_rows_per_s']:,.0f} "
        f"rows/s); predictions equal to the host's on {agree:.6f} of rows")
    if (probs.shape != (rows, classes) or not np.isfinite(probs).all()
            or np.abs(probs.sum(1) - 1.0).max() > 1e-4 or agree < 0.999):
        raise AssertionError(f"{name}: transform outputs are wrong")
    rec["model"] = model
    return rec


def phase_logistic(device, args) -> dict:
    """(a) bench.py's headline, (b) the reference benchmark's width, (c)
    softmax + OWL-QN + weights in float64, also fitted on the CPU."""
    from spark_rapids_ml_torch import set_default_device
    from spark_rapids_ml_torch.classification import LogisticRegression

    cells = []
    bench_kw = dict(regParam=1e-4, elasticNetParam=0.0, tol=1e-8)
    t0 = time.perf_counter()
    X, y = gen_binary(args.lr_rows, args.lr_dim, seed=0)
    log(f"  (a) data {X.shape} float32 from bench.py's _gen_binary(seed=0): "
        f"{time.perf_counter() - t0:.2f} s")
    sl = np.random.default_rng(args.seed + 11).choice(len(y), size=min(65536, len(y)),
                                                     replace=False)
    check_oracle("(a) 65,536-row slice", X[sl], y[sl], np.ones(len(sl), np.float32), 2, 1e-4,
                 1e-5, device, args.seed)
    cells.append(phase_logistic_cell(device, f"(a) {args.lr_rows}x{args.lr_dim} float32 binomial",
                                     X, y, None, 2, dict(bench_kw, maxIter=50), 1_000_000,
                                     args.seed, weight_col=False))
    model_a, X_a = cells[-1]["model"], X
    del X, y

    t0 = time.perf_counter()
    X, y = gen_binary(args.lr_wide_rows, args.lr_wide_dim, seed=0)
    log(f"  (b) data {X.shape} float32 from _gen_binary(seed=0): {time.perf_counter() - t0:.2f} s")
    cells.append(phase_logistic_cell(
        device, f"(b) {args.lr_wide_rows}x{args.lr_wide_dim} float32 binomial", X, y, None, 2,
        dict(bench_kw, maxIter=200), 1_000_000, args.seed, weight_col=False))
    X_wide = X  # phase 6 reuses these rows
    del X, y, cells[-1]["model"]

    n = args.lr_multi_rows
    X, y, w = gen_multiclass(n, 256, 5, seed=args.seed + 21)
    c_kw = dict(regParam=1e-3, elasticNetParam=0.5, float32_inputs=False)
    check_oracle("(c) float64", X, y, w, 5, 1e-3 * 0.5, 1e-12, device, args.seed + 1)
    rec = phase_logistic_cell(device, f"(c) {n}x256 float64 5 classes, elastic net, weights",
                              X, y, w, 5, c_kw, n, args.seed, weight_col=True)
    set_default_device("cpu")
    t0 = time.perf_counter()
    cpu = LogisticRegression(**c_kw).setWeightCol("wt").fit({"features": X, "label": y, "wt": w})
    t_cpu = time.perf_counter() - t0
    set_default_device(device)
    g = rec["model"]
    coef_rel = float(np.linalg.norm(g.coef_ - cpu.coef_) / np.linalg.norm(cpu.coef_))
    obj_rel = abs(g.objective - cpu.objective) / abs(cpu.objective)
    rec.update(cpu_fit_s=t_cpu, cpu_coef_rel=coef_rel, cpu_objective_rel=obj_rel)
    log(f"  (c) against the same fit on the CPU ({t_cpu:.2f} s, {cpu.summary.totalIterations} "
        f"iterations; card {g.summary.totalIterations}): coefficients {coef_rel:.3e} relative "
        f"(limit 1e-6), objective {obj_rel:.3e} (limit 1e-10); {int((g.coef_ == 0).sum())} of "
        f"{g.coef_.size} coefficients zero")
    if coef_rel > 1e-6 or obj_rel > 1e-10:
        raise AssertionError("(c): the fit on the card differs from the fit on the CPU")
    del rec["model"]
    cells.append(rec)
    for c in cells:
        c.pop("model", None)
    return {"cells": cells, "model": model_a, "X": X_a, "X_wide": X_wide}


# ---- PCA and LinearRegression -------------------------------------------------


def _fp32_bound_ms(nbytes: float, flops: float) -> tuple:
    """(bound ms, "bytes" or "operations"): the larger of the bytes at the
    card's memory rate and the IEEE float32 operations at its peak."""
    t_bytes = nbytes / _PEAK_BYTES_PER_S * 1e3
    t_ops = flops / _PEAK_FP32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _timed_fit(make, data, device):
    """(seconds, model, GB) of one `make().fit(data)`, the card idle before
    and after; GB is max_memory_allocated during the fit less what was
    allocated before it (a DeviceDataset's rows, for one): the memory the
    route itself takes."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    t0 = time.perf_counter()
    model = make().fit(data)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0, model,
            (torch.cuda.max_memory_allocated(device) - base) / 1e9)


def float64_stats(Xt, w=None, y=None) -> dict:
    """Weighted sums over the rows of the device tensor Xt in float64 on the
    card (a DGEMM over row chunks; TF32 never applies to float64), as host
    float64 arrays: gram, s1, sw, and with y also sxy, sy, syy.  The
    reference the port's float32 statistics are held against."""
    import torch

    n, d = Xt.shape
    dev, f64 = Xt.device, torch.float64
    out = {"gram": torch.zeros((d, d), dtype=f64, device=dev),
           "s1": torch.zeros(d, dtype=f64, device=dev), "sw": torch.zeros((), dtype=f64, device=dev)}
    if y is not None:
        out.update(sxy=torch.zeros(d, dtype=f64, device=dev),
                   sy=torch.zeros((), dtype=f64, device=dev),
                   syy=torch.zeros((), dtype=f64, device=dev))
    rows = max(1, (256 << 20) // (d * 8))
    for lo in range(0, n, rows):
        x = Xt[lo:lo + rows].to(f64)
        ww = (torch.ones(x.shape[0], dtype=f64, device=dev) if w is None
              else w[lo:lo + rows].to(f64))
        xw = x * ww[:, None]
        out["gram"].addmm_(xw.T, x)
        out["s1"] += xw.sum(0)
        out["sw"] += ww.sum()
        if y is not None:
            yy = y[lo:lo + rows].to(f64)
            out["sxy"].addmv_(xw.T, yy)
            out["sy"] += (yy * ww).sum()
            out["syy"] += (yy * yy * ww).sum()
    return {k: v.cpu().numpy() for k, v in out.items()}


def host_pca(st: dict, k: int):
    """(components (k, d), explained variance (k,)) of the float64
    covariance from `float64_stats`, eigendecomposed on the host in
    float64."""
    sw = float(st["sw"])
    mean = st["s1"] / sw
    cov = (st["gram"] - sw * np.outer(mean, mean)) / (sw - 1.0)
    evals, evecs = np.linalg.eigh(cov)
    return evecs[:, ::-1][:, :k].T, evals[::-1][:k]


def pca_agreement(comps, ev, ref_comps, ref_ev) -> tuple:
    """(the largest |1 - cosine| of the principal angles between the two
    subspaces, the largest relative difference of the explained
    variances).  A cosine can pass 1 by a float32 component's norm
    error."""
    cos = np.linalg.svd(np.asarray(comps, np.float64) @ np.asarray(ref_comps, np.float64).T,
                        compute_uv=False)
    ev_rel = float(np.max(np.abs(np.asarray(ev, np.float64) - ref_ev) / np.abs(ref_ev)))
    return float(np.abs(1.0 - cos).max()), ev_rel


def hold_pca(name: str, what: str, model, ref_comps, ref_ev, tol: float) -> dict:
    cos_err, ev_err = pca_agreement(model.components_, model.explained_variance_, ref_comps,
                                    ref_ev)
    log(f"  {name}: {what}: largest |1 - principal-angle cosine| {cos_err:.3e}, explained variance "
        f"{ev_err:.3e} relative (limits {tol:g})")
    if not (np.isfinite(model.components_).all() and cos_err <= tol and ev_err <= tol):
        raise AssertionError(f"{name}: {what}: the components differ beyond {tol:g}")
    return {"one_minus_cos": cos_err, "ev_rel": ev_err}


def _fused_numbers() -> dict:
    from spark_rapids_ml_torch import fused

    m = dict(fused.FUSED_METRICS)
    m.pop("stamp", None)
    return m


def phase_pca_cell(device, name: str, X, k: int, seed: int, ref_tol: float = 1e-4,
                   wide: bool = False) -> dict:
    """One PCA cell through the public entry points: the fits from a
    DeviceDataset (cold, least of three warm) with the statistics pass and
    the eigendecomposition timed apart, the fit from numpy (the fused pass
    at this size), a transform, each held against a float64 host
    eigendecomposition; at `wide`, also the full solver forced, and a fit
    from numpy with the fused pass off."""
    import torch

    from spark_rapids_ml_torch import DeviceDataset
    from spark_rapids_ml_torch import config as port_config
    from spark_rapids_ml_torch.feature import PCA
    from spark_rapids_ml_torch.ops import pca as port_pca

    n, d = X.shape
    rec = {"cell": name, "rows": n, "cols": d, "k": k, "dtype": "float32"}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ds = DeviceDataset.from_host(X, dtype=np.float32)
    torch.cuda.synchronize()
    rec["staging_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref_comps, ref_ev = host_pca(float64_stats(ds.X), k)
    log(f"  {name}: staging {rec['staging_s']:.3f} s ({X.nbytes / rec['staging_s'] / 1e9:.2f} "
        f"GB/s); float64 reference (card DGEMM + host eigh) {time.perf_counter() - t0:.2f} s")

    def make():
        return PCA(k=k).setInputCol("features").setOutputCol("pcs")

    rec["fit_cold_s"], model, _ = _timed_fit(make, ds, device)
    warm = [_timed_fit(make, ds, device) for _ in range(3)]
    rec["fit_warm_s"] = min(t for t, _, _ in warm)
    rec["max_memory_allocated_GB"] = {"device_dataset": max(g for _, _, g in warm)}
    rec["rows_per_s"] = n / rec["fit_warm_s"]
    dec = dict(port_pca.LAST_SOLVER_DECISION)
    rec["solver"], rec["solver_reason"] = dec["solver"], dec["reason"]
    w = ds.weight
    x_bytes = n * d * 4
    if rec["solver"] == "full":
        _, _, cov = port_pca.covariance(ds.X, w)
        rec["pass_ms"] = cuda_ms(lambda: port_pca.covariance(ds.X, w), reps=3)
        rec["eigh_ms"] = cuda_ms(lambda: torch.linalg.eigh(cov), reps=3)
        rec["pass_bound_ms"], rec["pass_bound_by"] = _fp32_bound_ms(x_bytes, 2.0 * n * d * d)
        log(f"  {name}: full solver ({rec['solver_reason']}): mean + covariance pass "
            f"{rec['pass_ms']:.3f} ms (bound {rec['pass_bound_ms']:.3f} ms by "
            f"{rec['pass_bound_by']}, share {rec['pass_bound_ms'] / rec['pass_ms']:.1%}); "
            f"eigh {rec['eigh_ms']:.3f} ms")
    else:
        l, p = dec["l"], dec["power_iters"]
        rec["randomized_ms"] = cuda_ms(
            lambda: port_pca.pca_fit_randomized(ds.X, w, k, l, p), reps=3)
        rec["randomized_bound_ms"], rec["randomized_bound_by"] = _fp32_bound_ms(
            x_bytes, (4 + 4 * p + 2) * n * d * l)
        log(f"  {name}: randomized solver ({rec['solver_reason']}, l={l}, power_iters={p}): "
            f"{rec['randomized_ms']:.3f} ms on the card, {3 + p} passes over X (bound "
            f"{rec['randomized_bound_ms']:.3f} ms by {rec['randomized_bound_by']}, share "
            f"{rec['randomized_bound_ms'] / rec['randomized_ms']:.1%})")
    wall_ms, rec["device_busy_share"] = device_busy_share(lambda: make().fit(ds))
    log(f"  {name}: fit from a DeviceDataset cold {rec['fit_cold_s']:.3f} s, least of three warm "
        f"{rec['fit_warm_s']:.4f} s ({rec['rows_per_s']:,.0f} rows/s); memory the fit adds "
        f"(max_memory_allocated) {rec['max_memory_allocated_GB']['device_dataset']:.2f} GB; one "
        f"warm fit under "
        f"torch.profiler {wall_ms:.3f} ms, the card busy {rec['device_busy_share'] or 0:.1%}")
    rec["check_device_dataset"] = hold_pca(name, "DeviceDataset fit vs the float64 host "
                                           "eigendecomposition", model, ref_comps, ref_ev,
                                           ref_tol)

    rec["fit_numpy_s"], model_np, gb = _timed_fit(make, X, device)
    rec["max_memory_allocated_GB"]["numpy"] = gb
    rec["fused"] = _fused_numbers()
    rec["solver_numpy"] = port_pca.LAST_SOLVER_DECISION["solver"]
    f = rec["fused"]
    log(f"  {name}: fit from numpy {rec['fit_numpy_s']:.3f} s ({n / rec['fit_numpy_s']:,.0f} "
        f"rows/s), route: fused {f.get('solver')} ({f.get('passes')} passes, {f.get('chunks')} "
        f"chunks, {f.get('bytes', 0) / 1e9:.2f} GB; prep {f.get('host_prep_s', 0):.3f} s, "
        f"accumulate {f.get('device_acc_s', 0):.3f} s, overlap {f.get('overlap_s', 0):.3f} s = "
        f"{f.get('overlap_fraction', 0):.1%}); memory the fit adds (max_memory_allocated) {gb:.2f} GB")
    if not f:
        raise AssertionError(f"{name}: the fit from numpy did not take the fused pass")
    rec["check_numpy"] = hold_pca(name, "fused fit from numpy vs the float64 host "
                                  "eigendecomposition", model_np, ref_comps, ref_ev, ref_tol)
    rec["check_fused_vs_two_phase"] = hold_pca(
        name, "fused fit vs the two-phase fit on the card", model_np, model.components_,
        model.explained_variance_.astype(np.float64), ref_tol)

    if wide:
        port_config.set_config(pca_solver="full")
        rec["fit_full_s"], m_full, gb = _timed_fit(make, ds, device)
        rec["max_memory_allocated_GB"]["device_dataset_full"] = gb
        _, _, cov = port_pca.covariance(ds.X, w)
        rec["full_pass_ms"] = cuda_ms(lambda: port_pca.covariance(ds.X, w), reps=1)
        rec["full_eigh_ms"] = cuda_ms(lambda: torch.linalg.eigh(cov), reps=1)
        del cov
        port_config.reset_config()
        b, by = _fp32_bound_ms(x_bytes, 2.0 * n * d * d)
        rec["full_pass_bound_ms"] = b
        log(f"  {name}: pca_solver=\"full\" from the DeviceDataset: fit {rec['fit_full_s']:.3f} s; "
            f"mean + Gram pass {rec['full_pass_ms']:.3f} ms (bound {b:.3f} ms by {by}, 2 n d^2 at "
            f"{_PEAK_FP32 / 1e12:g} TFLOP/s of IEEE float32: share {b / rec['full_pass_ms']:.1%}); "
            f"eigh {rec['full_eigh_ms']:.3f} ms; memory the fit adds (max_memory_allocated) {gb:.2f} GB")
        rec["check_full"] = hold_pca(name, "full solver vs the float64 host eigendecomposition",
                                     m_full, ref_comps, ref_ev, ref_tol)
        port_config.set_config(fused_stage_solve="off")
        rec["fit_numpy_two_phase_s"], m2, gb = _timed_fit(make, X, device)
        port_config.reset_config()
        rec["max_memory_allocated_GB"]["numpy_two_phase"] = gb
        log(f"  {name}: fit from numpy with fused_stage_solve=\"off\" (stage, then the "
            f"randomized passes on the card): {rec['fit_numpy_two_phase_s']:.3f} s, against "
            f"{rec['fit_numpy_s']:.3f} s fused; memory the fit adds (max_memory_allocated) {gb:.2f} GB")
        rec["check_numpy_two_phase"] = hold_pca(name, "two-phase fit from numpy vs the float64 "
                                                "host eigendecomposition", m2, ref_comps,
                                                ref_ev, ref_tol)

    rows = min(n, 1_000_000)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = model.transform(X[:rows])
    t_tr = time.perf_counter() - t0
    rec["transform_rows_per_s"] = rows / t_tr
    sl = slice(0, min(rows, 65536))
    want = X[sl].astype(np.float64) @ model.components_.astype(np.float64).T
    tr_err = float(np.abs(out[sl] - want).max() / np.abs(want).max())
    log(f"  {name}: transform of {rows} rows from numpy {t_tr:.3f} s "
        f"({rec['transform_rows_per_s']:,.0f} rows/s); against float64 host products "
        f"{tr_err:.3e} of the largest (limit 1e-5)")
    if out.shape != (rows, k) or not np.isfinite(out).all() or tr_err > 1e-5:
        raise AssertionError(f"{name}: transform outputs are wrong")
    del ds
    rec["model"] = model
    return rec


_LINREG_SETTINGS = (
    ("OLS", dict(regParam=0.0, standardization=False)),
    ("ridge", dict(regParam=1e-5, elasticNetParam=0.0)),
    ("elastic-net", dict(regParam=1e-5, elasticNetParam=0.5, maxIter=10, tol=1e-30)),
)


def phase_linreg_cell(device, name: str, X, seed: int) -> dict:
    """LinearRegression at the reference benchmark's three settings: per
    setting a fit from a DeviceDataset and one from numpy (the fused pass),
    the statistics pass, the host solve and the residual pass timed apart,
    the statistics of a 65,536-row slice held against a float64 host
    recomputation, the coefficients against the host solve of float64
    statistics."""
    import torch

    from spark_rapids_ml_torch import DeviceDataset
    from spark_rapids_ml_torch.ops import linear as port_linear
    from spark_rapids_ml_torch.ops.precision import ieee_matmul
    from spark_rapids_ml_torch.regression import LinearRegression

    n, d = X.shape
    rng = np.random.default_rng(seed)
    beta = torch.as_tensor(rng.standard_normal(d).astype(np.float32), device=device)
    noise = torch.as_tensor(rng.standard_normal(n).astype(np.float32), device=device)
    base = DeviceDataset.from_host(X, dtype=np.float32)
    with ieee_matmul():
        yt = base.X @ beta + 0.1 * noise
    y = yt.cpu().numpy()
    ds = DeviceDataset(base.device, base.X, n, y=yt, weight=base.weight)
    rec = {"cell": name, "rows": n, "cols": d, "dtype": "float32", "settings": []}

    # the statistics of a slice against a float64 host recomputation
    sl = slice(0, min(n, 65536))
    g, sxy = (t.cpu().numpy() for t in port_linear.linreg_sufficient_stats(
        ds.X[sl], ds.weight[sl], yt[sl])[:2])
    x64 = X[sl].astype(np.float64)
    hg, hsxy = x64.T @ x64, x64.T @ y[sl].astype(np.float64)
    rec["slice_gram_rel"] = float(np.abs(g - hg).max() / np.abs(hg).max())
    rec["slice_sxy_rel"] = float(np.abs(sxy - hsxy).max() / np.abs(hsxy).max())
    log(f"  {name}: statistics of a {sl.stop}-row slice against a float64 host recomputation: "
        f"gram {rec['slice_gram_rel']:.3e}, sxy {rec['slice_sxy_rel']:.3e} of the largest "
        f"(limit 1e-5)")
    if rec["slice_gram_rel"] > 1e-5 or rec["slice_sxy_rel"] > 1e-5:
        raise AssertionError(f"{name}: the sufficient statistics differ from the host's")

    stats = port_linear.linreg_sufficient_stats(ds.X, ds.weight, yt)
    rec["stats_ms"] = cuda_ms(lambda: port_linear.linreg_sufficient_stats(ds.X, ds.weight, yt),
                              reps=2)
    rec["stats_bound_ms"], by = _fp32_bound_ms(n * d * 4, 2.0 * n * d * d + 2.0 * n * d)
    host_stats = [t.cpu().numpy() for t in stats[:3]] + [t.item() for t in stats[3:]]
    del stats
    ref = float64_stats(ds.X, None, yt)
    log(f"  {name}: statistics pass (Gram, moments, cross terms) {rec['stats_ms']:.3f} ms on the "
        f"card (bound {rec['stats_bound_ms']:.3f} ms by {by}, 2 n d^2 at {_PEAK_FP32 / 1e12:g} "
        f"TFLOP/s of IEEE float32: share {rec['stats_bound_ms'] / rec['stats_ms']:.1%})")
    models = {}
    for label, kw in _LINREG_SETTINGS:
        s = {"setting": label, **kw}

        def make(kw=kw):
            return LinearRegression(**kw)

        s["fit_device_dataset_s"], m_ds, s["max_memory_allocated_GB_device_dataset"] = \
            _timed_fit(make, ds, device)
        est = make()
        p = est._tpu_params
        solve_kw = dict(reg_param=float(p["alpha"]), elasticnet_param=float(p["l1_ratio"]),
                        fit_intercept=bool(p["fit_intercept"]),
                        standardization=bool(p["standardization"]), tol=float(p["tol"]),
                        max_iter=int(p["max_iter"]))
        t0 = time.perf_counter()
        coef, b0, _ = port_linear.solve_linear_host(*host_stats, **solve_kw)
        s["host_solve_s"] = time.perf_counter() - t0
        coef_t = torch.as_tensor(coef, device=device).to(torch.float32)
        b_t = torch.tensor(b0, dtype=torch.float32, device=device)
        s["residual_ms"] = cuda_ms(
            lambda: port_linear.linreg_residual_sse(ds.X, ds.weight, yt, coef_t, b_t), reps=3)
        s["residual_bound_ms"] = n * d * 4 / _PEAK_BYTES_PER_S * 1e3
        s["fit_numpy_s"], m_np, s["max_memory_allocated_GB_numpy"] = _timed_fit(make, (X, y),
                                                                                device)
        s["fused"] = _fused_numbers()
        if not s["fused"]:
            raise AssertionError(f"{name} {label}: the fit from numpy did not take the fused pass")
        rcoef, rb0, _ = port_linear.solve_linear_host(
            ref["gram"], ref["sxy"], ref["s1"], float(ref["sw"]), float(ref["sy"]),
            float(ref["syy"]), **solve_kw)
        nrm = np.linalg.norm(rcoef)
        s["coef_rel_device_dataset"] = float(np.linalg.norm(m_ds.coef_ - rcoef) / nrm)
        s["coef_rel_numpy"] = float(np.linalg.norm(m_np.coef_ - rcoef) / nrm)
        s["coef_rel_fused_vs_two_phase"] = float(np.linalg.norm(m_np.coef_ - m_ds.coef_) / nrm)
        s["rmse"], s["r2"], s["n_iter"] = m_ds.summary.rootMeanSquaredError, m_ds.summary.r2, \
            m_ds.summary.totalIterations
        f = s["fused"]
        log(f"  {name} {label}: fit from a DeviceDataset {s['fit_device_dataset_s']:.3f} s "
            f"({n / s['fit_device_dataset_s']:,.0f} rows/s): statistics {rec['stats_ms']:.1f} ms, "
            f"host solve {s['host_solve_s']:.3f} s (float64, d = {d}), residual pass "
            f"{s['residual_ms']:.3f} ms (bound {s['residual_bound_ms']:.3f} ms by bytes, share "
            f"{s['residual_bound_ms'] / s['residual_ms']:.1%}); memory the fit adds "
            f"(max_memory_allocated) {s['max_memory_allocated_GB_device_dataset']:.2f} GB")
        log(f"  {name} {label}: fit from numpy (fused) {s['fit_numpy_s']:.3f} s: {f['chunks']} "
            f"chunks, {f['bytes'] / 1e9:.2f} GB, prep {f['host_prep_s']:.3f} s, accumulate "
            f"{f['device_acc_s']:.3f} s, overlap {f['overlap_s']:.3f} s "
            f"({f['overlap_fraction']:.1%}); memory the fit adds (max_memory_allocated) "
            f"{s['max_memory_allocated_GB_numpy']:.2f} GB")
        log(f"  {name} {label}: coefficients against the host solve of float64 statistics: "
            f"DeviceDataset {s['coef_rel_device_dataset']:.3e}, numpy {s['coef_rel_numpy']:.3e}, "
            f"fused vs two-phase {s['coef_rel_fused_vs_two_phase']:.3e} (limit 1e-4); rmse "
            f"{s['rmse']:.6g}, r2 {s['r2']:.9f}, {s['n_iter']} iterations")
        if (max(s["coef_rel_device_dataset"], s["coef_rel_numpy"],
                s["coef_rel_fused_vs_two_phase"]) > 1e-4 or not np.isfinite(s["rmse"])
                or not abs(m_ds.intercept - rb0) <= 1e-4 * max(1.0, abs(rb0))):
            raise AssertionError(f"{name} {label}: the coefficients differ from the host's")
        rec["settings"].append(s)
        models[label] = m_ds
    wall_ms, rec["device_busy_share_ridge"] = device_busy_share(
        lambda: LinearRegression(**_LINREG_SETTINGS[1][1]).fit(ds))
    log(f"  {name}: one warm ridge fit under torch.profiler {wall_ms:.3f} ms, the card busy "
        f"{rec['device_busy_share_ridge'] or 0:.1%} (the rest: the host solve)")
    rec["model"] = models["OLS"]
    return rec


def phase_float64_cell(device, n: int, seed: int) -> dict:
    """(g): float64 with sample weights, PCA k=10 and an elastic-net
    LinearRegression, fitted on the card and on the CPU."""
    from spark_rapids_ml_torch import DeviceDataset, set_default_device
    from spark_rapids_ml_torch.feature import PCA
    from spark_rapids_ml_torch.regression import LinearRegression

    d = 256
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)) * np.geomspace(4.0, 0.25, d)
    y = X @ rng.standard_normal(d) + 2.0 + 0.5 * rng.standard_normal(n)
    w = rng.uniform(0.2, 2.0, n)
    name = f"(g) {n}x{d} float64, weights"
    rec = {"cell": name, "rows": n, "cols": d, "dtype": "float64"}
    lr_kw = dict(regParam=1e-3, elasticNetParam=0.5, float32_inputs=False)
    frame = {"features": X, "label": y, "wt": w}
    fits = {}
    for where in (device, "cpu"):
        set_default_device(where)
        t0 = time.perf_counter()
        ds = DeviceDataset.from_host(X, y=y, weight=w, dtype=np.float64)
        pca = PCA(k=10, float32_inputs=False).fit(ds)
        lr_ds = LinearRegression(**lr_kw).fit(ds)
        lr_fused = LinearRegression(**lr_kw).setWeightCol("wt").fit(frame)
        fits[str(where)] = (time.perf_counter() - t0, pca, lr_ds, lr_fused)
        del ds
    set_default_device(device)
    (t_card, p_g, l_g, f_g), (t_cpu, p_c, l_c, f_c) = fits[str(device)], fits["cpu"]

    def rel(a, b):
        return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())

    rec.update(
        card_s=t_card, cpu_s=t_cpu,
        pca_components_rel=rel(p_g.components_, p_c.components_),
        pca_ev_rel=rel(p_g.explained_variance_, p_c.explained_variance_),
        linreg_coef_rel=rel(l_g.coef_, l_c.coef_),
        linreg_fused_coef_rel=rel(f_g.coef_, f_c.coef_),
        linreg_rmse_rel=max(abs(a.summary.rootMeanSquaredError / b.summary.rootMeanSquaredError
                                - 1.0) for a, b in ((l_g, l_c), (f_g, f_c))),
        linreg_r2_rel=max(abs(a.summary.r2 / b.summary.r2 - 1.0)
                          for a, b in ((l_g, l_c), (f_g, f_c))),
    )
    worst = max(rec[k] for k in ("pca_components_rel", "pca_ev_rel", "linreg_coef_rel",
                                 "linreg_fused_coef_rel", "linreg_rmse_rel", "linreg_r2_rel"))
    log(f"  {name}: PCA k=10 (DeviceDataset) and LinearRegression (elasticNetParam=0.5, "
        f"regParam=1e-3; DeviceDataset and fused from a frame) on the card {t_card:.2f} s and on "
        f"the CPU {t_cpu:.2f} s; card vs CPU: components {rec['pca_components_rel']:.3e}, "
        f"explained variance {rec['pca_ev_rel']:.3e}, coefficients {rec['linreg_coef_rel']:.3e} "
        f"(fused {rec['linreg_fused_coef_rel']:.3e}), rmse {rec['linreg_rmse_rel']:.3e}, r2 "
        f"{rec['linreg_r2_rel']:.3e} relative (limit 1e-9); {l_g.summary.totalIterations} "
        f"FISTA iterations")
    if not worst <= 1e-9:
        raise AssertionError(f"{name}: the card's fits differ from the CPU's beyond 1e-9")
    return rec


def phase_pca_linear(device, args, wide_X) -> dict:
    """(d) PCA k=3 at bench.py's 1M x 128, (e) PCA k=3 and (f)
    LinearRegression at the reference benchmark's 1M x 3000, (g) float64
    with weights, card against CPU."""
    cells = []
    t0 = time.perf_counter()
    X_d = np.random.default_rng(1).standard_normal((args.pca_rows, args.pca_dim)).astype(
        np.float32)
    log(f"  (d) data {X_d.shape} float32 from bench.py's _rng(1).standard_normal: "
        f"{time.perf_counter() - t0:.2f} s")
    cells.append(phase_pca_cell(device, f"(d) PCA k=3 {args.pca_rows}x{args.pca_dim}", X_d, 3,
                                args.seed))
    pca_model = cells[-1].pop("model")

    # (e): phase 5's (b) rows with three columns scaled by 16, 8 and 4, a
    # clear spectral gap, so that the top three components are defined (an
    # i.i.d. normal matrix has a flat spectrum); powers of two, so that
    # dividing again gives (f) the (b) rows bit for bit
    scale = np.array([16.0, 8.0, 4.0], np.float32)
    wide_X[:, :3] *= scale
    n, d = wide_X.shape
    cells.append(phase_pca_cell(device, f"(e) PCA k=3 {n}x{d}", wide_X, 3, args.seed, wide=True))
    cells[-1].pop("model")
    wide_X[:, :3] /= scale
    cells.append(phase_linreg_cell(device, f"(f) LinearRegression {n}x{d}", wide_X,
                                   args.seed + 41))
    linreg_model = cells[-1].pop("model")
    cells.append(phase_float64_cell(device, args.g_rows, args.seed + 51))
    return {"cells": cells, "pca_model": pca_model, "X_d": X_d, "linreg_model": linreg_model,
            "X_f": wide_X}


def phase_persistence(main: dict, logistic: dict, pca_linear: dict) -> None:
    from spark_rapids_ml_torch.classification import LogisticRegressionModel
    from spark_rapids_ml_torch.feature import PCAModel
    from spark_rapids_ml_torch.knn import NearestNeighborsModel
    from spark_rapids_ml_torch.regression import LinearRegressionModel

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
    X = logistic["X"][:100_000]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "lr_model")
        logistic["model"].save(path)
        loaded = LogisticRegressionModel.load(path)
    a, b = logistic["model"].transform(X), loaded.transform(X)
    same = all(np.array_equal(a[c], b[c]) for c in a)
    log(f"  LogisticRegressionModel save + load; transform of {len(X)} rows after load "
        f"identical: {same}")
    if not same:
        raise AssertionError("the loaded LogisticRegressionModel answers differently")
    for label, cls, model, X in (
            ("PCAModel of (d)", PCAModel, pca_linear["pca_model"], pca_linear["X_d"]),
            ("LinearRegressionModel of (f)", LinearRegressionModel, pca_linear["linreg_model"],
             pca_linear["X_f"])):
        X = X[:100_000]
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "model")
            model.save(path)
            loaded = cls.load(path)
        same = np.array_equal(model.transform(X), loaded.transform(X))
        log(f"  {label} save + load; transform of {len(X)} rows after load identical: {same}")
        if not same:
            raise AssertionError(f"the loaded {label} answers differently")


def phase_build(args) -> None:
    from spark_rapids_ml_torch.ops import _build
    from spark_rapids_ml_torch.ops import fused_knn as fk

    t0 = time.perf_counter()
    sources = _build.all_sources()
    _build.build(sources)
    log(f"  built {sources} in {time.perf_counter() - t0:.2f} s")
    for src in sources:
        for kern, r in ptxas_report(_build.BUILD_LOG[src]).items():
            log(f"    {src} {kern}: {r}")
        for line in _build.BUILD_LOG[src].splitlines():
            if "Performance Loss" in line:  # e.g. wgmma serialised by ptxas
                log(f"    {src}: {line.strip()}")
    lib = fk._lib()
    d_pad = fk.padded_width(args.dim)
    log(f"    dynamic shared memory: fused_knn_tf32_kernel {lib.fused_knn_tf32_smem_bytes(d_pad)}"
        f" B at d={args.dim} ({lib.fused_knn_tf32_stages(d_pad)} ring stages), "
        f"fused_knn_f64_kernel {lib.fused_knn_f64_smem_bytes(args.dim)} B")
    counts = sass_counts(_build._target("fused_knn.cu"), _build._nvcc())
    log(f"  tensor-core instructions in the SASS: {counts}")
    for kernel, op in (("fused_knn_tf32_kernel", "HGMMA"), ("fused_knn_f64_kernel", "DMMA")):
        found = [c[op] for name, c in counts.items() if name.startswith(kernel)]
        if not found or min(found) < 1:
            raise AssertionError(f"{kernel}: an instance's SASS holds no {op}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--items", type=int, default=1_000_000)
    ap.add_argument("--queries", type=int, default=10_000)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--k", type=int, default=32)
    ap.add_argument("--lr-rows", type=int, default=2_000_000)
    ap.add_argument("--lr-dim", type=int, default=256)
    ap.add_argument("--lr-wide-rows", type=int, default=1_000_000)
    ap.add_argument("--lr-wide-dim", type=int, default=3000)
    ap.add_argument("--lr-multi-rows", type=int, default=200_000)
    ap.add_argument("--pca-rows", type=int, default=1_000_000)
    ap.add_argument("--pca-dim", type=int, default=128)
    ap.add_argument("--g-rows", type=int, default=200_000)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from spark_rapids_ml_torch import set_default_device

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
    phase_build(args)

    log("phase 2: kernels vs their plain versions on the card")
    phase_kernels_vs_plain(device, args.seed)

    log(f"phase 3: main path, {args.items} x {args.dim} items, {args.queries} queries, k={args.k}")
    main_out = phase_main_path(device, args)

    log("phase 4: float64 path, a fifth of the items and queries; then the main shape")
    f64 = phase_float64_path(device, args)

    log("phase 5: LogisticRegression: (a) bench.py's headline, (b) the reference benchmark's "
        "width, (c) softmax + OWL-QN + weights in float64")
    logistic = phase_logistic(device, args)

    log("phase 6: PCA and LinearRegression: (d) PCA k=3 at bench.py's 1M x 128, (e) PCA k=3 "
        "and (f) LinearRegression at the reference benchmark's 1M x 3000, (g) float64 with "
        "weights, card against CPU")
    pca_linear = phase_pca_linear(device, args, logistic.pop("X_wide"))

    log("phase 7: persistence")
    phase_persistence(main_out, logistic, pca_linear)

    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"logistic": logistic["cells"]}))
    print(json.dumps({"pca_linear": pca_linear["cells"]}))
    print(json.dumps({"kernels": main_out["kernels"] + f64}))
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
