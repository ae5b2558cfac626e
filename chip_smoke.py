#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (spark_rapids_ml_torch) on one NVIDIA GPU.

Run from the root of a checkout:

    python3 chip_smoke.py [--seed 0] [--items 1000000] [--queries 10000]
                          [--dim 128] [--k 32] [--lr-rows 2000000] [--lr-dim 256]
                          [--lr-wide-rows 1000000] [--lr-wide-dim 3000]
                          [--lr-multi-rows 200000] [--pca-rows 1000000]
                          [--pca-dim 128] [--g-rows 200000] [--h-rows 100000000]
                          [--j-rows 300000] [--k-rows 200000] [--k-dbscan-rows 20000]
                          [--r-rows 2000000]

Phases, each of which makes the script exit non-zero when it fails:

1. card: the GPU's name and power limit, the torch and CUDA versions,
   whether pandas and pyarrow import (and their versions), the
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
   transform outputs);
8. KMeans and DBSCAN through the public entry points (no hand-written
   kernel: IEEE float32 cuBLAS products, `index_add_` and torch
   elementwise ops): (h) KMeans k=20 on BASELINE.json's 100,000,000 x 64
   float32 (standard normal rows made on the card, bench.py's
   `seed=0, maxIter=20`, k-means||), (i) the reference benchmark's
   kmeans_k1000_iter30 (`tol=1e-20, maxIter=30, initMode="random"`) on
   phase 5's (b) rows, 1,000,000 x 3000, from a DeviceDataset and from
   numpy, with a transform of 1,000,000 rows from numpy, (j) DBSCAN on
   bench.py's 300,000 x 16 blobs (60 centres, std 0.6, eps 1.2,
   min_samples 5) at the default byte cap and at 4096 MB, and in float64,
   (k) float64: KMeans k=10 on 200,000 x 256 with weights and DBSCAN on
   20,000 rows of blobs, on the card and on the CPU.  Each KMeans cell:
   the fit, the layers of a Lloyd pass (assign, update, and a one-hot
   matmul update beside it), the row norms, the seeding and the shift
   fetch, each beside its bound; held: trainingCost within 1e-5 of a
   float64 recomputation, the first three iterations from the fit's own
   initial centres against float64 on the card (each update within 1e-4
   of the float64 update of the same assignment; every row the float64
   distances assign elsewhere a near tie, 1e-5; at (h) an independent
   float64 Lloyd within 1e-4), the cost of every pass non-increasing
   (1e-6).  (j): sweeps, a pass beside its bounds, clusters and noise;
   held: the two caps give equal labels, and the float32 labels against
   float64 (ARI 0.999, or no more than N / 10,000 rows in another cluster,
   each in or next to a pair that float32 rounding decides).  (k): the
   card's centres within 1e-9 of the CPU's, the labels equal.  Then the
   KMeans model of (h) and a DBSCAN model saved and loaded.
9. RandomForestClassifier and RandomForestRegressor through the public
   entry points (no hand-written kernel: the histogram is `scatter_add_`
   over row chunks, the rest torch ops): (l) the reference benchmark's
   random_forest_classifier_50t_d13 (numTrees=50, maxDepth=13,
   maxBins=128, bench.py:1013-1016; 20 of its 50 trees) and (m)
   random_forest_regressor_30t_d6
   (numTrees=30, maxDepth=6, maxBins=128, a label made from the seed) on
   phase 5's (b) rows, 1,000,000 x 3000; (n) BASELINE.json's classifier
   (maxDepth=16, bench.py:221-224) on (h)'s 100,000,000 x 64 standard
   normal rows with a linear label, its 100 trees cut to 4;
   (o) float64 with weights in [0.2, 2), bootstrap and a feature subset
   (gini, entropy and variance), card against CPU.  Each of (l)-(n): fits
   from a DeviceDataset and from numpy (at (l) and (m) 10 trees: the
   same first trees), a transform of 1,000,000 rows, the
   card's busy share over a one-tree fit, and two trees (one at (n))
   grown by ops/forest.py `forest_fit` from draws the phase makes, with
   each layer (prep: the edges' sort and digitize; per tree: histogram,
   split search, routing and frontier, leaf statistics) timed with CUDA
   events beside its bytes bound, and the split search of one level
   timed in the fit's form (XLA-CPU rounding) and with torch.cumsum and
   plain arithmetic; held: (1) the root's and level 1's
   split on those trees equals the argmax of float64 gains from a
   `torch.bincount` histogram, or has a gain within 1e-6 of the argmax's
   relative to it; (2) every split node's count equals its children's
   and (3) every tree's leaves its root, exactly below 2^24 (the weights
   are integers), else 1e-6; (4) transform against the numpy predictor on
   10,000 rows (labels equal but at ties within 1e-6, probabilities 1e-6,
   regression 1e-5); the bin edges of four columns against a host sort
   and their bin ids against a count.  (o): (5) the card's trees equal the
   CPU's from the same draws (structure and thresholds exactly, leaf
   statistics, gains and counts 1e-9, predictions equal; a near tie that
   flips named, its gain gap held to 1e-12, and the nodes under it and the
   rows through it left out).  (m): whether two card fits
   from one seed give equal trees, reported.  Then the (l) and (m) models
   saved and loaded.
10. parquet and beyond the card's memory, through the public entry points
   (no hand-written kernel: the parquet decode on the host, the copies,
   and the statistics and solvers of phases 5, 6 and 8), in a temporary
   directory (its free space printed first; about 13 GB of disk): (p) phase 5's (b) rows and labels, 1,000,000 x 3000 float32,
   with (e)'s three scaled columns, written in bench.py:900-931's layout
   (FixedSizeList, 50,000-row row groups, about 12 GB); the decode alone
   (the range readers) as the rate a fit cannot beat; PCA k=3 and OLS on the
   fused pass from parquet, LogisticRegression (maxIter=200, (b)'s
   params) and KMeans k=1000 ((i)'s params) on stage_parquet + _fit_array,
   each held against the same estimator fitted from the rows in memory
   (components 1e-4, coefficients 1e-4, objective 1e-5, cost 1e-5) and the
   fused statistics against float64 (1e-5); (q) on the same file,
   LinearRegression routed to the streamed statistics by hbm_bytes below
   the file's size and PCA by force_streaming_stats, the statistics held
   against (p)'s and float64 (1e-5), the models against (p)'s (1e-4);
   (r) bench.py:454-487's streaming cell, 2,000,000 x 64 float32 with a
   binary label (about 512 MB, `--r-rows`), its decode alone by one scan
   and by the range readers: LogisticRegression
   (regParam=1e-4, maxIter=10, tol=0) and KMeans k=20 epoch by epoch,
   their epochs and rows/s per epoch; the logistic objective held against
   a float64 host recomputation (1e-5) and the in-memory fit of the same
   rows (1e-4: that fit standardizes by the sample std, and ten
   iterations converge neither), KMeans' cost against
   `kmeans_fit_stepwise`, which seeds from the same strided sample (1e-5).  Each
   fit prints its seconds and rows/s, its route's pass numbers
   (`LAST_STAGE`, `FUSED_METRICS`, `STREAM_METRICS`: host prep, device
   work, overlap), the reader count and its reason, and its peak device
   memory.  The chunk cache is on, as by default: (p)'s randomized PCA
   prints each of its four passes with its source (decode or replay),
   seconds, host prep and device time; (r) its first scan, first epoch
   and the mean of the later epochs; the cache's counters after (p), (q)
   and (r); no fit may take the out-of-memory retry, and each takes its
   PR 9 route beside (p)'s device tier.
11. the chunk cache and the statistics, on phase 10's files (the
   temporary directory is removed after this phase): (s) bench.py:552-640's
   epoch-cache cell, 400,000 x 64 float32 (seed 31, pandas' list layout)
   with host_batch_bytes = 16 MB, `linreg_streaming_stats` six times
   (epoch 1 fills, five replays from the device tier), then six more
   with the ledger held full (the pinned host tier); replay against replay
   bit for bit, fill against replay bit for bit (one row group, one
   reader); (t) DuHL on (r)'s file (host_batch_bytes = 16 MB: 31 chunks):
   LogisticRegression (regParam=1e-4, maxIter=50, tol=1e-6) and KMeans
   k=20, sampled and exact, held to the JAX package's DuHL test limits
   (coefficients 5e-3 relative, intercept 5e-3; cost 2%); (u) bench.py:
   518-549's summarize cell, 500,000 x 32 float32 (seed 11), its eight
   metrics in one pass and one by one, held against float64 numpy (1e-5)
   and the HyperLogLog estimate of the same registers from the numpy
   twin, then count, mean, variance, min, max, normL2, numNonZeros and
   distinctCount of (p)'s 12 GB file twice (a decode, then a replay), the
   moments against float64 (1e-5).
12. the meta layer through the public entry points (no hand-written
   kernel: the fits of phases 5 and 6, an `index_select` for each gathered
   view, the metrics on the host): (v) bench.py:1930-2010's cv_cached
   cell, 400,000 x 64 float32 from default_rng(17),
   CrossValidator of LinearRegression over regParam [0, 0.1, 1], 3 folds,
   seed 11, rmse: the legacy path (device_cache="off", a warm-up, then
   timed), the cached path cold and warm (a hit), each run's seconds,
   dataset stagings, peak card memory, avgMetrics and bestIndex; held:
   cached stagings 1 cold and 0 warm, bestIndex equal, avgMetrics within
   1e-6 relative of the legacy path's. (w) phase 5's (b) rows (1,000,000 x
   3000 float32, binary labels) and (b)'s Params: CrossValidator of
   LogisticRegression over regParam [1e-4, 1e-2], 3 folds,
   seed 11, areaUnderROC, cached (mask views) and then legacy, with the
   reservation against the budget; the cached run's host side apart
   (extraction, fingerprint, staging); fitMultiple of the two maps from
   the resident DeviceDataset against two fits (coefficients bit-equal);
   `evaluate` of the refit best model against a float64 host recount of
   its own predictions (accuracy, weighted precision and recall, 1e-12);
   held besides: one staging on the cached path, bestIndex equal,
   avgMetrics within 1e-6 relative of the legacy path's.

The last lines of standard output are a JSON object of the logistic
cells' numbers, one of the PCA and LinearRegression cells' numbers, one
of the clustering cells' numbers, one of the forest cells' numbers
({"forest": [...]}), one of the parquet cells' numbers
({"parquet": [...]}), one of the chunk cache and statistics cells'
numbers ({"cache_stats": [...]}), one of the meta layer's cells
({"meta": [...]}), a JSON object of the kernels' numbers,
the card's name and power limit, and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
No JAX is imported.
"""
from __future__ import annotations

import argparse
import contextlib
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
    X_wide, y_wide = X, y  # phases 6, 8 and 9 reuse these rows, phase 9 their labels
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
    return {"cells": cells, "model": model_a, "X": X_a, "X_wide": X_wide, "y_wide": y_wide}


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


# ---- KMeans and DBSCAN ---------------------------------------------------------


def _blocks(n: int, rows: int):
    for lo in range(0, n, rows):
        yield slice(lo, min(lo + rows, n))


def _share(bound_ms: float, ms: float) -> str:
    return f"bound {bound_ms:.3f} ms, share {bound_ms / ms:.1%}"


def _sqdist64(Xb, C64):
    """(rows, k) float64 squared distances of a block (cast on the card)."""
    import torch

    Xb = Xb.double()
    d2 = torch.addmm((Xb * Xb).sum(1)[:, None], Xb, C64.T, alpha=-2.0)
    return d2.add_((C64 * C64).sum(1)).clamp_(min=0.0)


def cost64(X, w, C, rows: int) -> float:
    """The weighted cost of centres C over the card's rows X, in float64
    (DGEMM over row blocks): the reference for `trainingCost`."""
    import torch

    C64 = torch.as_tensor(C, device=X.device).double()
    total = torch.zeros((), dtype=torch.float64, device=X.device)
    for b in _blocks(X.shape[0], rows):
        total += (_sqdist64(X[b], C64).min(dim=1).values * w[b].double()).sum()
    return float(total)


def lloyd_vs_float64(X, w, C0, iters: int, rows: int) -> dict:
    """`iters` Lloyd iterations of the port from C0 (its `assign`,
    `lloyd_pass` and centre update, in X's dtype) against float64 on the
    card, per iteration:
    - step: the float64 update over the port's own assignment, from the
      port's current centres: the update's arithmetic (centres_rel_step);
    - assignment: the float64 nearest centre from the same centres: the
      rows assigned differently (flips_step) and the largest relative gap
      of their two float64 distances (a flip is right only at a near tie);
    - trajectory: an independent float64 Lloyd from C0 (centres_rel,
      flips against it)."""
    import torch

    from spark_rapids_ml_torch.ops import kmeans as km

    n = X.shape[0]
    k, d = C0.shape
    C32, C64 = C0.to(X.dtype), C0.double()
    x2 = km.row_norms(X)
    unweighted = bool((w == 1).all())
    z = dict(dtype=torch.float64, device=X.device)

    def mean(s, c, old):
        return torch.where(c[:, None] > 0, s / torch.where(c > 0, c, 1.0)[:, None], old)

    out = {"centres_rel_step": [], "flips_step": [], "flip_gap_max": [], "centres_rel": [],
           "flips": []}
    for _ in range(iters):
        sums, counts = km.lloyd_pass(X, w, C32, x2, rows, unweighted)[:2]
        s_step, c_step = torch.zeros((k, d), **z), torch.zeros(k, **z)
        s64, c64 = torch.zeros((k, d), **z), torch.zeros(k, **z)
        flips_step = torch.zeros((), dtype=torch.int64, device=X.device)
        flips = torch.zeros((), dtype=torch.int64, device=X.device)
        gap = torch.zeros((), **z)
        C32d = C32.double()
        for b in _blocks(n, rows):
            Xb, wb = X[b].double(), w[b].double()
            lab32 = km.assign(X[b], C32, x2[b])[0]
            d2 = _sqdist64(X[b], C32d)
            lab_same = d2.argmin(dim=1)
            flip = lab_same != lab32
            flips_step += flip.sum()
            if bool(flip.any()):
                a = d2[flip].gather(1, lab32[flip][:, None])[:, 0]
                m = d2[flip].gather(1, lab_same[flip][:, None])[:, 0]
                gap = torch.maximum(gap, ((a - m) / m.clamp_min(1e-300)).max())
            s_step.index_add_(0, lab32, Xb * wb[:, None])
            c_step.index_add_(0, lab32, wb)
            lab64 = _sqdist64(X[b], C64).argmin(dim=1)
            flips += (lab64 != lab32).sum()
            s64.index_add_(0, lab64, Xb * wb[:, None])
            c64.index_add_(0, lab64, wb)
        step = mean(s_step, c_step, C32d)
        C32, _ = km._lloyd_center_update(C32, sums, counts)
        C64 = mean(s64, c64, C64)
        out["centres_rel_step"].append(float((C32.double() - step).abs().max() / step.abs().max()))
        out["flips_step"].append(int(flips_step))
        out["flip_gap_max"].append(float(gap))
        out["centres_rel"].append(float((C32.double() - C64).abs().max() / C64.abs().max()))
        out["flips"].append(int(flips))
    return out


def kmeans_layers(X, w, C, seed_args, rows: int) -> dict:
    """The layers of one Lloyd pass timed apart with CUDA events at the
    fit's centres and block rows, and the seeding and the shift fetch on
    the host's clock, each beside its bound."""
    import torch

    from spark_rapids_ml_torch.ops import kmeans as km

    n, d = X.shape
    k = C.shape[0]
    isz = X.element_size()
    unweighted = bool((w == 1).all())
    x2 = km.row_norms(X)
    blocks = list(_blocks(n, rows))
    out = {"block_rows": rows, "blocks_per_pass": len(blocks)}
    out["row_norms_ms"] = cuda_ms(lambda: km.row_norms(X), reps=2)
    out["row_norms_bound_ms"] = n * d * isz / _PEAK_BYTES_PER_S * 1e3
    out["assign_ms"] = cuda_ms(lambda: [km.assign(X[b], C, x2[b]) for b in blocks], reps=3)
    # the function: X and x2 read once, labels (int64) and distances written
    out["assign_bound_ms"], out["assign_bound_by"] = _fp32_bound_ms(
        n * d * isz + n * (isz + 8 + isz), 2.0 * n * d * k)
    labels = torch.cat([km.assign(X[b], C, x2[b])[0] for b in blocks])

    def update():
        for b in blocks:
            part = torch.zeros((k, d), dtype=X.dtype, device=X.device)
            part.index_add_(0, labels[b], X[b] if unweighted else X[b] * w[b][:, None])
            torch.zeros(k, dtype=X.dtype, device=X.device).index_add_(0, labels[b], w[b])

    def update_onehot():
        for b in blocks:
            onehot = torch.nn.functional.one_hot(labels[b], k).to(X.dtype) * w[b][:, None]
            onehot.T @ X[b]

    out["update_ms"] = cuda_ms(update, reps=3)
    out["update_bound_ms"] = (n * d * isz + n * (8 + isz)) / _PEAK_BYTES_PER_S * 1e3
    from spark_rapids_ml_torch.ops.precision import ieee_matmul

    with ieee_matmul():
        out["update_onehot_matmul_ms"] = cuda_ms(update_onehot, reps=2)
    del labels
    prev = torch.full((n,), -1, dtype=torch.int32, device=X.device)
    out["pass_ms"] = cuda_ms(lambda: km.lloyd_pass(X, w, C, x2, rows, unweighted, prev), reps=3)
    del prev
    out["pass_bound_ms"], out["pass_bound_by"] = _fp32_bound_ms(
        n * d * isz + n * isz, 2.0 * n * d * k)
    # the shift fetch: one scalar to the host, the card idle
    shift2 = ((C - C) ** 2).sum(1).max()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):
        float(shift2)
    out["shift_fetch_ms"] = (time.perf_counter() - t0) * 10.0
    Xs, ws, k_, seed, init = seed_args
    km._seed(Xs, ws, k_, seed, init, 2, 2.0)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    km._seed(Xs, ws, k_, seed, init, 2, 2.0)
    torch.cuda.synchronize()
    out["seed_ms"] = (time.perf_counter() - t0) * 1e3
    out["seed_rows"] = int(Xs.shape[0])
    return out


def phase_kmeans_cell(device, name: str, X, w, k: int, fit_kw: dict, host_X=None,
                      hold_trajectory: bool = True) -> dict:
    """One KMeans cell through the public entry points, from the rows of
    the DeviceDataset-like (X, w) on the card: the fit (and, with
    `host_X`, a fit from numpy and a transform from numpy), its layers
    beside their bounds, and the checks: trainingCost against a float64
    recomputation (1e-5); the first three iterations from the fit's own
    initial centres against float64 (`lloyd_vs_float64`): every update
    within 1e-4 of the float64 update of the same assignment, every row
    the float64 distances assign elsewhere a near tie (1e-5), and with
    `hold_trajectory` an independent float64 Lloyd within 1e-4; the cost of
    every pass non-increasing."""
    import torch

    from spark_rapids_ml_torch import DeviceDataset
    from spark_rapids_ml_torch.clustering import KMeans
    from spark_rapids_ml_torch.ops import kmeans as km

    n, d = X.shape
    rec = {"cell": name, "rows": n, "cols": d, "k": k, "dtype": "float32", "params": fit_kw}
    ds = DeviceDataset(device, X, n, weight=w)

    def make():
        return KMeans(k=k, **fit_kw)

    rec["fit_s"], model, gb = _timed_fit(make, ds, device)
    fit = dict(km.LAST_FIT)
    rec.update(n_iter=model.n_iter_, moved=fit["moved"], stepwise=fit["stepwise"],
               seed_stride=fit["stride"],
               seed_rows=fit["init_rows"], rows_per_s=n / rec["fit_s"],
               max_memory_allocated_GB=gb,
               fit_memory_total_GB=torch.cuda.max_memory_allocated(device) / 1e9)
    costs = fit["costs"]
    rec["costs"] = costs
    log(f"  {name}: fit from a DeviceDataset {rec['fit_s']:.3f} s ({rec['rows_per_s']:,.0f} "
        f"rows/s), {model.n_iter_} iterations (rows moved per pass {fit['moved']}), stepwise "
        f"branch {fit['stepwise']} (seeding on "
        f"{fit['init_rows']} rows, stride {fit['stride']}), {fit['rows']} rows per block; "
        f"memory the fit adds {gb:.2f} GB (max_memory_allocated {rec['fit_memory_total_GB']:.2f}"
        f" GB with the rows)")
    C = torch.tensor(model.cluster_centers_, device=device)
    p = make()._tpu_params
    seed, init = int(p["random_state"]), str(p["init"])
    # the rows the fit seeded on
    Xs, ws = ((X[::fit["stride"]].contiguous(), w[::fit["stride"]].contiguous())
              if fit["stride"] > 1 else (X, w))
    L = kmeans_layers(X, w, C, (Xs, ws, k, seed, init), fit["rows"])
    rec["layers"] = L
    log(f"  {name}: one Lloyd pass {L['pass_ms']:.3f} ms ({_share(L['pass_bound_ms'], L['pass_ms'])}"
        f" by {L['pass_bound_by']}): assign {L['assign_ms']:.3f} ms ("
        f"{_share(L['assign_bound_ms'], L['assign_ms'])} by {L['assign_bound_by']}), update "
        f"(index_add_) {L['update_ms']:.3f} ms ({_share(L['update_bound_ms'], L['update_ms'])} by "
        f"bytes; a one-hot matmul update would take {L['update_onehot_matmul_ms']:.3f} ms); "
        f"{L['blocks_per_pass']} blocks; row norms once per fit {L['row_norms_ms']:.3f} ms "
        f"({_share(L['row_norms_bound_ms'], L['row_norms_ms'])}); seeding {L['seed_ms']:.3f} ms on "
        f"{L['seed_rows']} rows; shift fetch {L['shift_fetch_ms']:.4f} ms; final cost = one pass")
    wall_ms, rec["device_busy_share"] = device_busy_share(lambda: make().fit(ds))
    log(f"  {name}: one fit under torch.profiler {wall_ms:.1f} ms, the card busy in kernels "
        f"{rec['device_busy_share'] or 0:.1%} of it")

    # checks
    ref = cost64(X, w, C, fit["rows"])
    rec["cost_rel_float64"] = abs(model.summary.trainingCost - ref) / ref
    rises = [(b - a) / a for a, b in zip(costs, costs[1:])]
    rec["cost_largest_rise"] = max(rises) if rises else 0.0
    C0 = km._seed(Xs, ws, k, seed, init, 2, 2.0)  # the fit's own initial centres
    del Xs, ws
    lv = lloyd_vs_float64(X, w, C0, 3, fit["rows"])
    rec["three_iterations_vs_float64"] = lv
    log(f"  {name}: trainingCost {model.summary.trainingCost!r} vs float64 recomputation "
        f"{ref!r}: {rec['cost_rel_float64']:.3e} relative (limit 1e-5); the cost of the "
        f"{len(costs)} passes: largest relative rise {rec['cost_largest_rise']:.3e} (limit 1e-6, "
        f"rounding of the float32 distances)")
    log(f"  {name}: three iterations from the fit's initial centres against float64 on the "
        f"card: each update against the float64 update of the same assignment "
        f"{lv['centres_rel_step']} relative (limit 1e-4); rows the float64 distances assign "
        f"elsewhere {lv['flips_step']}, their largest relative gap {lv['flip_gap_max']} (limit "
        f"1e-5: a near tie); an independent float64 Lloyd: centres {lv['centres_rel']} relative "
        f"(limit 1e-4{'' if hold_trajectory else ' not held here: a flipped row moves a centre of about n / k rows by a share of its norm'}), rows assigned "
        f"differently {lv['flips']}")
    if (not np.isfinite(model.cluster_centers_).all() or model.cluster_centers_.shape != (k, d)
            or rec["cost_rel_float64"] > 1e-5 or max(lv["centres_rel_step"]) > 1e-4
            or max(lv["flip_gap_max"]) > 1e-5
            or (hold_trajectory and max(lv["centres_rel"]) > 1e-4)
            or rec["cost_largest_rise"] > 1e-6):
        raise AssertionError(f"{name}: the KMeans fit fails its checks")

    if host_X is not None:
        rec["fit_numpy_s"], model_np, gb = _timed_fit(make, host_X, device)
        rec["max_memory_allocated_GB_numpy"] = gb
        same = (np.array_equal(model_np.cluster_centers_, model.cluster_centers_)
                and model_np.inertia_ == model.inertia_)
        rec["numpy_fit_bit_equal"] = same
        rec["numpy_fit_cost_rel"] = abs(model_np.inertia_ - model.inertia_) / model.inertia_
        rec["numpy_fit_centres_rel"] = float(
            np.abs(model_np.cluster_centers_ - model.cluster_centers_).max()
            / np.abs(model.cluster_centers_).max())
        log(f"  {name}: fit from numpy (staging included) {rec['fit_numpy_s']:.3f} s "
            f"({n / rec['fit_numpy_s']:,.0f} rows/s), memory it adds {gb:.2f} GB; against the "
            f"DeviceDataset fit: bit-equal {same}, cost {rec['numpy_fit_cost_rel']:.3e}, centres "
            f"{rec['numpy_fit_centres_rel']:.3e} relative")
        rows = min(n, 1_000_000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lab = model.transform(host_X[:rows])
        t_tr = time.perf_counter() - t0
        rec["transform_rows_per_s"] = rows / t_tr
        want = torch.cat([km.assign(X[b], C.to(X.dtype))[0]
                          for b in _blocks(rows, fit["rows"])]).cpu().numpy()
        agree = float((lab == want).mean())
        rec["transform_agree"] = agree
        log(f"  {name}: transform of {rows} rows from numpy {t_tr:.3f} s "
            f"({rec['transform_rows_per_s']:,.0f} rows/s); labels equal to the card's assign "
            f"over the fit's blocks on {agree:.6f} of rows (limit 0.999: other row counts may "
            f"take other cuBLAS kernels, which can move a near tie)")
        if lab.dtype != np.int32 or agree < 0.999:
            raise AssertionError(f"{name}: transform labels are wrong")
    rec["model"] = model
    return rec


def make_blobs(n: int, d: int, centres: int, std: float, seed: int):
    """scikit-learn's `make_blobs` (the card has no scikit-learn): centres
    uniform in (-10, 10)^d, n // centres rows each (the first n % centres
    take one more), gaussian with `std`, rows shuffled."""
    rng = np.random.default_rng(seed)
    cent = rng.uniform(-10.0, 10.0, (centres, d))
    sizes = np.full(centres, n // centres)
    sizes[: n % centres] += 1
    idx = np.repeat(np.arange(centres), sizes)
    X = cent[idx] + std * rng.standard_normal((n, d))
    perm = rng.permutation(n)
    return X[perm], idx[perm]


def adjusted_rand(a, b) -> float:
    """Adjusted Rand index of two labelings (noise, -1, a label like any)."""
    _, ai = np.unique(a, return_inverse=True)
    _, bi = np.unique(b, return_inverse=True)
    _, nij = np.unique(ai.astype(np.int64) * (bi.max() + 1) + bi, return_counts=True)

    def pairs(x):
        x = np.asarray(x, np.float64)
        return (x * (x - 1) / 2).sum()

    s, sa, sb = pairs(nij), pairs(np.bincount(ai)), pairs(np.bincount(bi))
    expected = sa * sb / pairs([len(a)])
    top = (sa + sb) / 2
    return 1.0 if top == expected else float((s - expected) / (top - expected))


def partition_differences(a, c) -> np.ndarray:
    """Rows of labeling `a` that do not sit in the cluster of `c` that shares
    the most rows with their cluster of `a` (noise, -1, matched to noise)."""
    m = int(c.max()) + 2
    keys = (a.astype(np.int64) + 1) * m + (c.astype(np.int64) + 1)
    uk, cnt = np.unique(keys, return_counts=True)
    partner = np.full(int(a.max()) + 2, -1)  # by label + 1; noise stays -1
    for la in np.unique(a[a >= 0]):
        sel = (uk // m) == la + 1
        partner[la + 1] = uk[sel][np.argmax(cnt[sel])] % m - 1
    return np.flatnonzero(partner[a + 1] != c)


def _f32_slack(x2_a, x2_b, d: int):
    """A bound on the float32 rounding of x2_a - 2 a.b + x2_b (the
    matmul identity): (2 d + 4) u (x2_a + x2_b), u = 2^-24."""
    return (2 * d + 4) * 2.0 ** -24 * (x2_a + x2_b)


def near_threshold_rows(Xt, eps: float, rows: int = 512):
    """Rows of the card's rows Xt in a pair whose float64 squared distance
    lies within the float32 rounding bound of eps^2 (a pair float32 may
    decide either way), as a bool tensor."""
    import torch

    X64 = Xt.double()
    x2 = (X64 * X64).sum(1)
    e2, d = eps * eps, X64.shape[1]
    out = torch.zeros(X64.shape[0], dtype=torch.bool, device=Xt.device)
    for b in _blocks(X64.shape[0], rows):
        d2 = torch.addmm(x2[b][:, None], X64[b], X64.T, alpha=-2.0).add_(x2)
        out[b] = ((d2 - e2).abs() <= _f32_slack(x2[b][:, None], x2, d)).any(dim=1)
    return out


def explained_by_near_ties(Xt, diff, eps: float) -> int:
    """How many of the rows `diff` sit in such a near-threshold pair or
    have a float64 eps-neighbour (within the slack) that does: a degree,
    and so a core mark, that float32 rounding may decide."""
    near = near_threshold_rows(Xt, eps)
    X64 = Xt.double()
    x2 = (X64 * X64).sum(1)
    explained = 0
    for r in diff.tolist():
        d2 = x2[r] - 2.0 * (X64 @ X64[r]) + x2
        nb = d2 <= eps * eps + _f32_slack(x2[r], x2, X64.shape[1])
        explained += int(bool(near[r]) or bool((near & nb).any()))
    return explained


def phase_dbscan_cell(device, name: str, X, eps: float, min_samples: int) -> dict:
    """DBSCAN through the public entry points at the default byte cap and
    at 4096 MB: time, sweeps, time per pass beside its bounds, clusters and
    noise; held: the float32 labels against a float64 run on the card
    (ARI >= 0.999)."""
    import torch

    from spark_rapids_ml_torch.clustering import DBSCAN
    from spark_rapids_ml_torch.ops import dbscan as db

    n, d = X.shape
    rec = {"cell": name, "rows": n, "cols": d, "eps": eps, "min_samples": min_samples, "runs": {}}
    # one pass over all N^2 pairs: the function reads X once and does 2 N^2 d
    # operations; the torch form also writes and reads the N^2 float32 distances
    rec["pass_bound_ms"] = 2.0 * n * n * d / _PEAK_FP32 * 1e3
    rec["pass_materialised_bound_ms"] = 2.0 * n * n * 4 / _PEAK_BYTES_PER_S * 1e3
    labels = {}
    for cap, dtype in ((None, np.float32), (4096, np.float32), (4096, np.float64)):
        key = f"{'default' if cap is None else cap} MB {np.dtype(dtype).name}"
        kw = dict(eps=eps, min_samples=min_samples, float32_inputs=dtype == np.float32)
        if cap:
            kw["max_mbytes_per_batch"] = cap
        t, model, gb = _timed_fit(lambda: DBSCAN(**kw), X, device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
        t0 = time.perf_counter()
        lab = model.transform(X.astype(dtype))
        torch.cuda.synchronize()
        r = dict(db.LAST_RUN, seconds=time.perf_counter() - t0,
                 max_memory_allocated_GB=(torch.cuda.max_memory_allocated(device) - base) / 1e9)
        r["passes"] = r["sweeps"] + 2
        r["clusters"] = int(lab.max() + 1)
        r["noise_share"] = float((lab == -1).mean())
        # one pass timed alone on the card
        Xt = torch.tensor(X.astype(dtype), device=device)
        x2 = (Xt * Xt).sum(1)
        valid = torch.ones(n, dtype=Xt.dtype, device=device)
        lab0 = torch.full((n,), n, dtype=torch.int32, device=device)
        e = torch.tensor(eps, dtype=Xt.dtype, device=device)
        one_pass = lambda: db._reduce(Xt, x2, valid, lab0, e * e, n, r["block"])  # noqa: E731
        r["pass_ms"] = cuda_ms(one_pass, reps=1)
        if cap is not None and dtype == np.float32:
            wall, r["device_busy_share"] = device_busy_share(lambda: model.transform(X))
        else:
            wall, r["device_busy_share_one_pass"] = device_busy_share(one_pass)
        del Xt, x2, valid, lab0
        rec["runs"][key] = r
        labels[key] = lab
        log(f"  {name}, cap {key}: {r['seconds']:.2f} s, {r['sweeps']} sweeps ({r['passes']} "
            f"passes of {r['tiles_per_pass']} tiles of {r['block']} columns), a pass "
            f"{r['pass_ms']:.1f} ms on the card (bound {rec['pass_bound_ms']:.1f} ms by "
            f"operations, share {rec['pass_bound_ms'] / r['pass_ms']:.1%}; the written and read "
            f"N^2 distances {rec['pass_materialised_bound_ms']:.1f} ms, share "
            f"{rec['pass_materialised_bound_ms'] / r['pass_ms']:.1%}); {r['clusters']} clusters, "
            f"noise {r['noise_share']:.4f}; memory the transform adds "
            f"{r['max_memory_allocated_GB']:.2f} GB; card busy "
            f"{r.get('device_busy_share', r.get('device_busy_share_one_pass')) or 0:.1%}"
            f"{'' if 'device_busy_share' in r else ' (one pass)'}")
    a, b, c = labels.values()
    rec["ari_float32_vs_float64"] = adjusted_rand(a, c)
    diff = partition_differences(a, c)
    rec["rows_differ_float32_vs_float64"] = int(diff.size)
    rec["caps_equal"] = bool(np.array_equal(a, b))
    # a row may differ only where float32 rounding decides a pair at eps
    rec["rows_differ_explained"] = explained_by_near_ties(
        torch.tensor(X, device=device), diff, eps) if diff.size else 0
    log(f"  {name}: float32 (default cap) vs float64 labels: ARI "
        f"{rec['ari_float32_vs_float64']:.6f} (limit 0.999), {diff.size} rows in another "
        f"cluster, {rec['rows_differ_explained']} of them in or next to a pair whose float64 "
        f"squared distance lies within float32's rounding bound of eps^2; the two caps give "
        f"equal labels: {rec['caps_equal']}")
    if not rec["caps_equal"] or rec["rows_differ_explained"] < diff.size or (
            rec["ari_float32_vs_float64"] < 0.999 and diff.size > max(1, n // 10_000)):
        raise AssertionError(f"{name}: DBSCAN labels fail their checks")
    return rec


def phase_clustering_float64(device, n: int, n_dbscan: int, seed: int) -> dict:
    """(k): float64, KMeans k=10 on n x 256 rows of ten blobs with sample
    weights, and DBSCAN on n_dbscan rows of ten 16-wide blobs (std 0.3,
    eps 1.2) and 500 uniform rows, on the card and on the CPU: the same
    centres (1e-9) and the same labels."""
    import torch

    from spark_rapids_ml_torch import set_default_device
    from spark_rapids_ml_torch.clustering import DBSCAN, KMeans

    d, k = 256, 10
    rng = np.random.default_rng(seed)
    cent = rng.uniform(-5.0, 5.0, (k, d))
    X = cent[rng.integers(k, size=n)] + rng.standard_normal((n, d))
    w = rng.uniform(0.2, 2.0, n)
    blobs, _ = make_blobs(n_dbscan - 500, 16, k, 0.3, seed=seed + 1)
    Xd = np.concatenate([blobs, rng.uniform(-10.0, 10.0, (500, 16))])
    name = f"(k) KMeans k={k} on {n}x{d} (weights) and DBSCAN on {n_dbscan}x16 blobs, float64"
    rec = {"cell": name, "rows": n, "cols": d, "dtype": "float64"}
    out = {}
    for where, on_card in ((device, True), ("cpu", False)):
        set_default_device(where)
        if on_card:
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        m = KMeans(k=k, seed=0, float32_inputs=False).setWeightCol("wt").fit(
            {"features": X, "wt": w})
        t_km = time.perf_counter() - t0
        t0 = time.perf_counter()
        lab = DBSCAN(eps=1.2, min_samples=5, float32_inputs=False).fit(Xd).transform(Xd)
        out[on_card] = (m, lab, t_km, time.perf_counter() - t0)
        if on_card:
            rec["max_memory_allocated_GB"] = torch.cuda.max_memory_allocated(device) / 1e9
            _, rec["device_busy_share_kmeans"] = device_busy_share(
                lambda: KMeans(k=k, seed=0, float32_inputs=False).setWeightCol("wt").fit(
                    {"features": X, "wt": w}))
    set_default_device(device)
    (mg, lg, tg, tdg), (mc, lc, tc, tdc) = out[True], out[False]
    Cg, Cc = mg.cluster_centers_, mc.cluster_centers_
    dist = np.sqrt(((Cg[:, None] - Cc[None]) ** 2).sum(-1))
    match = dist.argmin(axis=1)
    rec.update(card_kmeans_s=tg, cpu_kmeans_s=tc, card_dbscan_s=tdg, cpu_dbscan_s=tdc,
               centres_rel=float(dist.min(axis=1).max() / np.abs(Cc).max()),
               cost_rel=abs(mg.inertia_ - mc.inertia_) / mc.inertia_,
               dbscan_labels_equal=bool(np.array_equal(lg, lc)),
               dbscan_clusters=int(lg.max() + 1), dbscan_noise=int((lg == -1).sum()))
    log(f"  {name}: KMeans card {tg:.2f} s ({mg.n_iter_} iterations), CPU {tc:.2f} s "
        f"({mc.n_iter_}); centres {rec['centres_rel']:.3e} and cost {rec['cost_rel']:.3e} "
        f"relative (limit 1e-9); DBSCAN card {tdg:.2f} s, CPU {tdc:.2f} s, labels equal "
        f"{rec['dbscan_labels_equal']} ({rec['dbscan_clusters']} clusters, "
        f"{rec['dbscan_noise']} noise rows); max_memory_allocated "
        f"{rec['max_memory_allocated_GB']:.2f} GB; card busy in a KMeans fit "
        f"{rec['device_busy_share_kmeans'] or 0:.1%}")
    if (sorted(match) != list(range(k)) or rec["centres_rel"] > 1e-9 or rec["cost_rel"] > 1e-9
            or not rec["dbscan_labels_equal"] or rec["dbscan_clusters"] != k):
        raise AssertionError(f"{name}: the card's clustering differs from the CPU's")
    return rec


def phase_clustering(device, args, wide_X) -> dict:
    """(h) KMeans k=20 at BASELINE.json's 100M x 64, (i) the reference
    benchmark's kmeans_k1000_iter30 on phase 5's 1M x 3000 rows, (j) DBSCAN
    on bench.py's 300k x 16 blobs, (k) float64 card against CPU; then the
    KMeans and DBSCAN models saved and loaded."""
    import torch

    from spark_rapids_ml_torch import DeviceDataset
    from spark_rapids_ml_torch.clustering import DBSCAN, DBSCANModel, KMeansModel

    cells = []
    torch.cuda.empty_cache()
    n = args.h_rows
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(args.seed)
    X = torch.randn((n, 64), generator=gen, device=device, dtype=torch.float32)
    w = torch.ones(n, device=device)
    torch.cuda.synchronize()
    log(f"  (h) data {tuple(X.shape)} float32 standard normal, made on the card: "
        f"{time.perf_counter() - t0:.2f} s")
    cells.append(phase_kmeans_cell(device, f"(h) KMeans k=20 {n}x64", X, w, 20,
                                   dict(seed=0, maxIter=20)))
    km_model, X_h = cells[-1].pop("model"), X[:100_000].cpu().numpy()
    del X, w
    torch.cuda.empty_cache()

    Xi = wide_X
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ds = DeviceDataset.from_host(Xi, dtype=np.float32)
    torch.cuda.synchronize()
    t_stage = time.perf_counter() - t0
    log(f"  (i) phase 5's (b) rows {Xi.shape} staged into a DeviceDataset: {t_stage:.2f} s "
        f"({Xi.nbytes / t_stage / 1e9:.2f} GB/s)")
    cells.append(phase_kmeans_cell(
        device, f"(i) kmeans_k1000_iter30 {Xi.shape[0]}x{Xi.shape[1]}", ds.X, ds.weight, 1000,
        dict(tol=1e-20, maxIter=30, initMode="random"), host_X=Xi, hold_trajectory=False))
    cells[-1]["staging_s"] = t_stage
    cells[-1].pop("model")
    del ds
    torch.cuda.empty_cache()

    Xj, _ = make_blobs(args.j_rows, 16, 60, 0.6, seed=9)
    Xj = Xj.astype(np.float32)
    cells.append(phase_dbscan_cell(device, f"(j) DBSCAN {args.j_rows}x16 blobs", Xj, 1.2, 5))
    torch.cuda.empty_cache()
    cells.append(phase_clustering_float64(device, args.k_rows, args.k_dbscan_rows,
                                          args.seed + 61))

    with tempfile.TemporaryDirectory() as tmp:
        km_model.save(os.path.join(tmp, "km"))
        loaded = KMeansModel.load(os.path.join(tmp, "km"))
        DBSCAN(eps=1.2, min_samples=5).fit(Xj).save(os.path.join(tmp, "db"))
        db = DBSCANModel.load(os.path.join(tmp, "db"))
    same = np.array_equal(km_model.transform(X_h), loaded.transform(X_h))
    log(f"  KMeansModel of (h) save + load; transform of {len(X_h)} rows after load identical: "
        f"{same}; DBSCANModel save + load keeps eps {db.getEps()} and min_samples "
        f"{db.getMinSamples()}")
    if not same or db.getEps() != 1.2 or db.getMinSamples() != 5:
        raise AssertionError("the loaded clustering models differ")
    return {"cells": cells}


# ---- RandomForest --------------------------------------------------------------


class LayerTimer:
    """The `timer=` of ops/forest.py `forest_fit`: CUDA events around each
    layer, summed by layer name (device milliseconds between the events,
    which is the layer's kernels when the host keeps ahead of the card)."""

    def __init__(self) -> None:
        self.spans: dict = {}

    @contextlib.contextmanager
    def span(self, name: str):
        import torch

        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        try:
            yield
        finally:
            end.record()
            self.spans.setdefault(name, []).append((start, end))

    def totals(self) -> dict:
        import torch

        torch.cuda.synchronize()
        return {name: {"ms": sum(s.elapsed_time(e) for s, e in ev), "calls": len(ev)}
                for name, ev in self.spans.items()}


def forest_draws(n: int, d: int, n_trees: int, depth: int, max_active: int, max_features: int,
                 dtype, device, seed: int) -> list:
    """The phase's own draws for `n_trees` trees, from a generator of its
    own: Poisson(1) row weights and, where features are subsampled, a
    standard Gumbel matrix per level."""
    import torch

    from spark_rapids_ml_torch.ops.forest import TreeDraws

    gen = torch.Generator(device=device).manual_seed(seed)
    tiny, top = torch.finfo(dtype).tiny, 1.0 - torch.finfo(dtype).eps

    def gumbel(a):
        u = torch.rand((a, d), generator=gen, dtype=dtype, device=device).clamp_(tiny, top)
        return -torch.log(-torch.log(u))

    out = []
    for _ in range(n_trees):
        w = torch.poisson(torch.ones(n, dtype=dtype, device=device), generator=gen)
        g = ([gumbel(min(1 << lv, max_active)) for lv in range(depth)]
             if max_features < d else None)
        out.append(TreeDraws(w, g))
    return out


def hist64(Xb, labels, v, n_bins: int, n_classes: int):
    """(d, B, S) float64 histogram of the rows' weights `v` by feature and
    bin, by `torch.bincount` over blocks of features (not the fit's
    scatter): S = n_classes class counts, or (w, w y, w y^2) for
    regression (n_classes 0)."""
    import torch

    m, d = Xb.shape
    S = n_classes or 3
    out = torch.empty((d, n_bins, S), dtype=torch.float64, device=Xb.device)
    fb = max(1, (1 << 30) // (16 * m))
    chans = None if n_classes else (v, v * labels, v * labels * labels)
    for f0 in range(0, d, fb):
        f1 = min(f0 + fb, d)
        nb = (f1 - f0) * n_bins
        idx = Xb[:, f0:f1].long() + torch.arange(f1 - f0, device=Xb.device) * n_bins
        if n_classes:
            flat = (idx * S + labels[:, None]).flatten()
            h = torch.bincount(flat, weights=v[:, None].expand(m, f1 - f0).flatten(),
                               minlength=nb * S).view(f1 - f0, n_bins, S)
        else:
            flat = idx.flatten()
            h = torch.stack([torch.bincount(flat, weights=c[:, None].expand(m, f1 - f0).flatten(),
                                            minlength=nb) for c in chans], dim=-1)
            h = h.view(f1 - f0, n_bins, S)
        out[f0:f1] = h
        del idx, flat, h
    return out


def gains64(H, n_classes: int, entropy: bool, min_instances: float):
    """float64 impurity decrease of every (feature, bin) split of one node
    from its (d, B, S) histogram (-inf where a child is too small), and the
    node's impurity."""
    import torch

    def impurity(st):
        if not n_classes:
            n = st[..., 0]
            mean = st[..., 1] / n.clamp_min(1e-300)
            return torch.where(n > 0, (st[..., 2] / n.clamp_min(1e-300) - mean * mean)
                               .clamp_min(0.0), 0.0), n
        n = st.sum(-1)
        p = st / n.clamp_min(1e-300)[..., None]
        if entropy:
            imp = -torch.where(p > 0, p * torch.log(p), 0.0).sum(-1)
        else:
            imp = 1.0 - (p * p).sum(-1)
        return torch.where(n > 0, imp, 0.0), n

    cum = H.cumsum(1)
    total = cum[:, -1]
    left, right = cum[:, :-1], total[:, None] - cum[:, :-1]
    ip, n_parent = impurity(total[0])
    il, nl = impurity(left)
    ir, nr = impurity(right)
    gain = ip - (nl * il + nr * ir) / n_parent
    ok = (nl >= min_instances) & (nr >= min_instances)
    return torch.where(ok, gain, float("-inf")), float(ip)


def hold_splits(name, trees, draws, Xb, edges, labels, valid, n_classes, entropy, max_features,
                min_instances: float = 1.0) -> list:
    """Check 1: the root's and level 1's chosen split against the argmax
    of the float64 gains of a histogram recomputed by `hist64`, under the
    tree's own draws; a split that is not that argmax must have a float64
    gain within 1e-6 of the argmax's, relative to it (the largest gap is
    reported, and also relative to the node's impurity)."""
    import torch

    d = Xb.shape[1]
    out = []
    for t, dr in enumerate(draws):
        v = dr.weights.double() * valid.double()
        lc = int(trees.left_child[t, 0])
        nodes = [(0, 0, 0, None)]
        if trees.feature[t, 0] >= 0:
            f0 = int(trees.feature[t, 0])
            b0 = int(torch.searchsorted(edges[:, f0].contiguous(),
                                        torch.tensor([float(trees.threshold[t, 0])],
                                                     dtype=edges.dtype, device=edges.device)))
            go_left = Xb[:, f0].long() <= b0
            nodes += [(lc, 1, 0, go_left), (lc + 1, 1, 1, ~go_left)]
        for node, level, slot, rows in nodes:
            f_t = int(trees.feature[t, node])
            if f_t < 0:
                continue
            vv = v if rows is None else v * rows
            G, ip = gains64(hist64(Xb, labels, vv, edges.shape[0] + 1, n_classes), n_classes,
                            entropy, min_instances)
            if max_features < d:
                g = dr.gumbels[level][slot]
                G = torch.where((g >= torch.sort(g).values[d - max_features])[:, None], G,
                                float("-inf"))
            best = int(torch.argmax(G.flatten()))
            f_b, b_b = divmod(best, G.shape[1])
            thr = torch.tensor([float(trees.threshold[t, node])], dtype=edges.dtype,
                               device=edges.device)
            b_t = int(torch.searchsorted(edges[:, f_t].contiguous(), thr))
            g_best, g_t = float(G[f_b, b_b]), float(G[f_t, b_t])
            same = f_t == f_b and float(edges[b_b, f_b]) == float(trees.threshold[t, node])
            rec = {"tree": t, "node": node, "chosen": [f_t, b_t], "float64_argmax": [f_b, b_b],
                   "equal": same, "gap_rel_impurity": (g_best - g_t) / max(ip, 1e-300),
                   "gap_rel_gain": (g_best - g_t) / max(abs(g_best), 1e-300),
                   "gain_float64": g_best, "node_impurity": ip,
                   "recorded_gain_rel": (abs(float(trees.gain[t, node]) - g_t)
                                         / max(abs(g_t), 1e-300))}
            out.append(rec)
            if not same and rec["gap_rel_gain"] > 1e-6:
                raise AssertionError(f"{name}: tree {t} node {node} split {f_t}/{b_t} is not the "
                                     f"float64 argmax {f_b}/{b_b}: {rec}")
    n_equal = sum(r["equal"] for r in out)
    worst = max((r["gap_rel_gain"] for r in out), default=0.0)
    worst_imp = max((r["gap_rel_impurity"] for r in out), default=0.0)
    log(f"  {name}: check 1, {len(out)} splits of the root and level 1 against the float64 "
        f"argmax of a bincount histogram: {n_equal} equal; the largest gain gap {worst:.3e} of "
        f"the best gain (limit 1e-6), {worst_imp:.3e} of the node's impurity")
    return out


def hold_counts(name: str, trees, classification: bool, exact: bool) -> dict:
    """Checks 2 and 3 on every tree: a split node's count against its
    children's (a child's count where it was on a frontier, else the weight
    of its leaf statistics), and each tree's leaves against its root:
    exactly where the weights are integers and the counts below 2^24, else
    1e-6 relative."""
    leaf_w = trees.leaf_stats.sum(-1) if classification else trees.leaf_stats[..., 0]
    leaf_w = leaf_w.astype(np.float64)
    count = trees.count.astype(np.float64)
    worst_node, worst_tree = 0.0, 0.0
    for t in range(trees.feature.shape[0]):
        f, lc = trees.feature[t], trees.left_child[t]
        weight = np.where(count[t] > 0, count[t], leaf_w[t])
        split = np.flatnonzero(f >= 0)
        kids = weight[lc[split]] + weight[lc[split] + 1]
        worst_node = max(worst_node, float(np.max(np.abs(kids - count[t, split])
                                                  / count[t, split])) if len(split) else 0.0)
        reach = np.zeros(len(f), bool)
        reach[0] = True
        for i in range(len(f)):
            if reach[i] and f[i] >= 0:
                reach[lc[i]] = reach[lc[i] + 1] = True
        leaves = leaf_w[t][reach & (f < 0)].sum()
        worst_tree = max(worst_tree, abs(leaves - count[t, 0]) / count[t, 0])
    limit = 0.0 if exact else 1e-6
    log(f"  {name}: checks 2-3 on {trees.feature.shape[0]} trees: split node count vs its "
        f"children's {worst_node:.3e}, leaves vs root {worst_tree:.3e} relative (limit "
        f"{'exact' if exact else '1e-6'})")
    if worst_node > limit or worst_tree > limit:
        raise AssertionError(f"{name}: node counts do not add up")
    return {"count_vs_children_rel": worst_node, "leaves_vs_root_rel": worst_tree}


def hold_prep(name: str, X, w, edges, Xb, seed: int) -> None:
    """The fit's bin edges of four columns against a host recomputation
    (numpy's order statistics of the column at the same quantile
    positions) and their bin ids against a count of the edges below each
    value on the card: both exact."""
    import torch

    n, d = X.shape
    B = edges.shape[0] + 1
    # four columns, one at 100M rows (a host partition of 1e8 values takes seconds)
    cols = np.random.default_rng(seed).choice(d, size=min(4, d, max(1, 40_000_000 // n)),
                                              replace=False)
    ok = (w > 0).cpu().numpy()
    n_eff = int(ok.sum())
    q = np.clip((np.arange(1, B, dtype=np.int64) * n_eff) // B, 0, n - 1)
    for f in cols:
        col = X[:, f].cpu().numpy()
        want = np.partition(np.where(ok, col, np.inf), q)[q]
        want = np.where(np.isfinite(want), want, np.finfo(col.dtype).max)
        if not np.array_equal(edges[:, f].cpu().numpy(), want):
            raise AssertionError(f"{name}: bin edges of column {f} differ from the host's")
        for b in _blocks(n, 1 << 22):
            ids = (X[b, f, None] > edges[None, :, f]).sum(1)
            if not torch.equal(ids, Xb[b, f].long()):
                raise AssertionError(f"{name}: bin ids of column {f} are wrong")
    log(f"  {name}: prep held: the edges of columns {cols.tolist()} equal the host's order "
        f"statistics, their bin ids a count of the edges below each value")


def forest_bounds(n: int, d: int, S: int, B: int, depth: int, max_active: int, itemsize: int,
                  bin_bytes: int, classification: bool) -> dict:
    """Bytes bounds (ms at 3.35 TB/s) of one tree's layers, summed over its
    levels: the histogram reads the bin ids, the row slot (int64) and the
    rows' weighted statistics once and writes the (A B, d, S) table once;
    the split search reads that table once; the routing reads one bin id,
    the slot and the node of each row and writes slot and node; the leaf
    statistics read each row's node, class or channels and weight once.
    Prep: the sort reads X and writes the edges; digitize reads X and
    writes the bin ids."""
    widths = [min(1 << lv, max_active) for lv in range(depth)]
    # a row's weight and int64 class id, or its three weighted channels
    row_stats = (8 + itemsize) if classification else 3 * itemsize
    hist = sum(n * d * bin_bytes + n * 8 + n * row_stats + a * B * d * S * itemsize
               for a in widths)
    split = sum(a * B * d * S * itemsize for a in widths)
    route = depth * n * (bin_bytes + 4 * 8)
    leaf = n * (8 + row_stats)
    ms = 1e3 / _PEAK_BYTES_PER_S
    return {"histogram": hist * ms, "split": split * ms, "route": route * ms,
            "leaf": leaf * ms, "prep.edges": n * d * itemsize * ms,
            "prep.digitize": n * d * (itemsize + bin_bytes) * ms}


def plain_best_splits(hist, criterion: int, min_instances: float, fmask):
    """ops/forest.py `_best_splits` with `torch.cumsum` and plain multiply
    and add in place of its XLA-CPU rounding (the cumsum blocked in 16s,
    the fused multiply-adds emulated): what that rounding costs the split
    layer."""
    import torch

    from spark_rapids_ml_torch.ops import forest as pf

    def impurity(st):
        if criterion == pf.VARIANCE:
            n = st[..., 0]
            sn = n.clamp_min(1e-12)
            mean = st[..., 1] / sn
            return torch.where(n > 0, (st[..., 2] / sn - mean * mean).clamp_min(0.0), 0.0), n
        n = st.sum(-1)
        p = st / n.clamp_min(1e-12)[..., None]
        imp = (1.0 - (p * p).sum(-1) if criterion == pf.GINI
               else -torch.where(p > 0, p * torch.log(p), 0.0).sum(-1))
        return torch.where(n > 0, imp, 0.0), n

    A, d, B, S = hist.shape
    cum = hist.cumsum(2)
    total, left = cum[:, :, -1, :], cum[:, :, : B - 1, :]
    right = total[:, :, None, :] - left
    ip, n_parent = impurity(total[:, 0, :])
    il, nl = impurity(left)
    ir, nr = impurity(right)
    gain = ip[:, None, None] - (nl * il + nr * ir) / n_parent.clamp_min(1e-12)[:, None, None]
    gain = torch.where((nl >= min_instances) & (nr >= min_instances), gain, float("-inf"))
    if fmask is not None:
        gain = torch.where(fmask[:, :, None], gain, float("-inf"))
    flat = gain.reshape(A, -1)
    best = torch.argmax(flat, dim=1)
    return best, flat.gather(1, best[:, None])[:, 0], n_parent, nl


def time_split_forms(device, Xb, labels, n_bins: int, n_classes: int, criterion: int, K: int,
                     A: int, seed: int) -> dict:
    """The split search of one level of A nodes, the fit's form (XLA-CPU
    rounding) against `plain_best_splits`, on the histogram of the cell's
    bin ids with rows dealt to the A nodes at random and a random feature
    subset of K: device ms of each (CUDA events, mean of 3 after a warm
    run) and on how many nodes the two choose the same split."""
    import torch

    from spark_rapids_ml_torch.ops import forest as pf

    n, d = Xb.shape
    gen = torch.Generator(device=device).manual_seed(seed)
    slot = torch.randint(0, A, (n,), generator=gen, device=device)
    if n_classes:
        values, classes, S = torch.ones(n, device=device), labels, n_classes
    else:
        yf = labels.float()
        values, classes, S = torch.stack([torch.ones_like(yf), yf, yf * yf], 1), None, 3
    hist = pf._histogram(Xb, slot, A, n_bins, values, classes, S)
    g = torch.rand((A, d), generator=gen, device=device)
    fmask = (g >= torch.sort(g, dim=1).values[:, d - K, None]) if K < d else None
    del slot, values
    forms = {"xla_rounding": pf._best_splits, "plain": plain_best_splits}
    out = {"nodes": A}
    best = {}
    for form, fn in forms.items():
        best[form] = fn(hist, criterion, 1.0, fmask)[0]
        out[f"{form}_ms"] = cuda_ms(lambda: fn(hist, criterion, 1.0, fmask), 3, warm=False)
    out["same_split_nodes"] = int((best["xla_rounding"] == best["plain"]).sum())
    return out


def phase_forest_cell(device, name: str, X, y, make, host_X, host_y, n_classes: int,
                      entropy: bool, check_trees: int, seed: int, transform_rows: int,
                      numpy_trees=None) -> dict:
    """One RandomForest cell through the public entry points, from the rows
    X, labels y on the card (a DeviceDataset of weight 1) and from numpy
    (`host_X`, `host_y`; `numpy_trees` cuts that fit's trees, which are
    the first trees of the other fit): both fits, a transform of `transform_rows` rows
    from numpy, the card's busy share over a one-tree fit, the layers of
    `check_trees` trees grown by ops/forest.py `forest_fit` from draws made
    here (the fit's params, its `timer=`) beside their bounds, and checks
    1-4 (check 1 on those trees, 2-3 on every tree of the fit, 4 on 10,000
    rows)."""
    import torch

    from spark_rapids_ml_torch import DeviceDataset
    from spark_rapids_ml_torch.models.tree import _resolve_max_features
    from spark_rapids_ml_torch.ops import forest as pf

    n, d = X.shape
    w = torch.ones(n, dtype=X.dtype, device=device)
    ds = DeviceDataset(device, X, n, y=y, weight=w)
    est = make()
    p = est._tpu_params
    depth, B, n_trees = int(p["max_depth"]), int(p["n_bins"]), int(p["n_estimators"])
    classification = n_classes > 0
    K = _resolve_max_features(p["max_features"], d, classification)
    rec = {"cell": name, "rows": n, "cols": d, "dtype": str(X.dtype).replace("torch.", ""),
           "trees": n_trees, "max_depth": depth, "max_bins": B, "features_per_node": K,
           "classes": n_classes}

    rec["fit_s"], model, gb = _timed_fit(make, ds, device)
    rec.update(rows_per_s=n / rec["fit_s"], tree_s=rec["fit_s"] / n_trees,
               max_memory_beyond_X_GB=gb, split_nodes=int((model.feature >= 0).sum()))
    log(f"  {name}: fit from a DeviceDataset {rec['fit_s']:.3f} s ({rec['rows_per_s']:,.0f} rows/s,"
        f" {rec['tree_s']:.3f} s a tree), {rec['split_nodes']} split nodes in {n_trees} trees; "
        f"memory the fit adds beyond X {gb:.2f} GB")
    # Poisson weights are integers: counts are exact while below 2^24
    rec["counts"] = hold_counts(name, model, classification, exact=2 * n < (1 << 24))

    t_np = numpy_trees or n_trees
    rec["fit_numpy_s"], model_np, gb_np = _timed_fit(lambda: make(numTrees=t_np),
                                                     (host_X, host_y), device)
    rec.update(numpy_trees=t_np, rows_per_s_numpy=n / rec["fit_numpy_s"],
               tree_s_numpy=rec["fit_numpy_s"] / t_np, max_memory_numpy_GB=gb_np)
    same = all(np.array_equal(getattr(model, k)[:t_np], getattr(model_np, k))
               for k in ("feature", "threshold", "left_child", "leaf_stats", "count"))
    rec["numpy_fit_trees_equal"] = same
    log(f"  {name}: fit from numpy of {t_np} trees (staging included) {rec['fit_numpy_s']:.3f} s "
        f"({rec['rows_per_s_numpy']:,.0f} rows/s, {rec['tree_s_numpy']:.3f} s a tree), memory it "
        f"adds {gb_np:.2f} GB; the same seed's trees equal the DeviceDataset fit's: {same}")
    del model_np

    rows = min(n, transform_rows)
    Xt = host_X[:rows]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = model.transform(Xt)
    rec["transform_rows"] = rows
    rec["transform_rows_per_s"] = rows / (time.perf_counter() - t0)
    # check 4: transform against the numpy predictor on 10,000 rows
    rows4 = min(rows, 10_000)
    host = model.cpu()
    if classification:
        pred = out["prediction"][:rows4]
        want = host.predict(Xt[:rows4])
        probs = out["probability"][:rows4]
        err = float(np.abs(probs - host.predict_proba(Xt[:rows4])).max())
        top2 = np.sort(probs, axis=1)[:, -2:]
        tie = (top2[:, 1] - top2[:, 0]) <= 1e-6
        bad = int(((pred != want) & ~tie).sum())
        rec["check4"] = {"labels_differ": int((pred != want).sum()), "at_ties": int(tie.sum()),
                         "prob_max_abs": err}
        ok4 = bad == 0 and err <= 1e-6
    else:
        want = host.predict(Xt[:rows4])
        err = float(np.abs(out[:rows4] - want).max() / np.abs(want).max())
        rec["check4"] = {"pred_max_rel": err}
        ok4 = err <= 1e-5
    log(f"  {name}: transform of {rows} rows from numpy {rows / rec['transform_rows_per_s']:.3f} s "
        f"({rec['transform_rows_per_s']:,.0f} rows/s); check 4, against the numpy predictor on "
        f"{rows4} rows: {rec['check4']} (labels equal but at ties within 1e-6, probabilities "
        f"1e-6; regression 1e-5 of the largest prediction)")
    if not ok4:
        raise AssertionError(f"{name}: transform disagrees with the numpy predictor")

    wall_ms, rec["device_busy_share"] = device_busy_share(lambda: make(numTrees=1).fit(ds))
    log(f"  {name}: a one-tree fit under torch.profiler {wall_ms:.1f} ms, the card busy in "
        f"kernels {rec['device_busy_share'] or 0:.1%} of it")

    # the layers, and check 1, on trees grown from the phase's own draws
    draws = forest_draws(n, d, check_trees, depth, int(p["max_active_nodes"]), K, X.dtype,
                         device, seed)
    timer = LayerTimer()
    crit = est._criterion()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trees = pf.forest_fit(X, y, w, 0, n_trees=check_trees, max_depth=depth, n_bins=B,
                          criterion=crit, n_classes=n_classes, max_features=K,
                          min_instances=float(p["min_samples_leaf"]),
                          min_info_gain=float(p["min_impurity_decrease"]), bootstrap=True,
                          subsample=1.0, max_active=int(p["max_active_nodes"]), draws=draws,
                          timer=timer)
    wall = time.perf_counter() - t0
    tot = timer.totals()
    S = n_classes or 3
    bounds = forest_bounds(n, d, S, B, depth, int(p["max_active_nodes"]), X.element_size(),
                           pf.bin_dtype(B).itemsize, classification)
    layers = {}
    for layer, v in tot.items():
        per_tree = not layer.startswith("prep")
        ms = v["ms"] / (check_trees if per_tree else 1)
        layers[layer] = {"ms_per_tree" if per_tree else "ms": ms, "calls": v["calls"],
                         "bound_ms": bounds[layer], "share_of_bound": bounds[layer] / ms}
    tree_ms = sum(layers[k]["ms_per_tree"] for k in ("histogram", "split", "route", "leaf"))
    for k in ("histogram", "split", "route", "leaf"):
        layers[k]["share_of_tree"] = layers[k]["ms_per_tree"] / tree_ms
    rec["layers"] = layers
    rec["layered_run_s"] = wall
    log(f"  {name}: layers over {check_trees} trees grown from the phase's draws ({wall:.3f} s):"
        + "".join(f"\n    {k}: {v.get('ms_per_tree', v.get('ms')):.3f} ms"
                  f"{' a tree' if 'ms_per_tree' in v else ''}, {v['calls']} calls, bound "
                  f"{v['bound_ms']:.3f} ms by bytes ({v['share_of_bound']:.2%})"
                  + (f", {v['share_of_tree']:.1%} of a tree" if 'share_of_tree' in v else "")
                  for k, v in layers.items()))
    edges = pf.compute_bin_edges(X, B, valid=w)
    Xb = pf.digitize(X, edges)
    hold_prep(name, X, w, edges, Xb, seed)
    labels = y.long() if classification else y.double()
    rec["check1"] = hold_splits(name, trees, draws, Xb, edges, labels, w, n_classes, entropy, K)
    hold_counts(name + " (phase's draws)", trees, classification, exact=2 * n < (1 << 24))
    A = min(1 << (depth - 1), int(p["max_active_nodes"]))
    rec["split_forms"] = time_split_forms(device, Xb, y.long() if classification else y, B,
                                          n_classes, crit, K, A, seed)
    log(f"  {name}: the split search of one level of {A} nodes, the fit's XLA-CPU rounding "
        f"against torch.cumsum and plain arithmetic: {rec['split_forms']}")
    del Xb, edges, draws
    rec["model"] = model
    return rec


def _below(left_a, left_b, i: int) -> list:
    """Table ids under node i in either of two trees' `left_child` rows."""
    out, todo = set(), [i]
    while todo:
        j = todo.pop()
        for lc in (left_a, left_b):
            if lc[j] >= 0:
                kids = {int(lc[j]), int(lc[j]) + 1} - out
                out |= kids
                todo.extend(kids)
    return sorted(out)


def phase_forest_float64(device, n: int, seed: int) -> dict:
    """(o) float64, non-integer weights in [0.2, 2), bootstrap and a feature
    subset: a gini and an entropy classifier on ten blobs and a regressor
    on a smooth label, each grown by ops/forest.py `forest_fit` on the card
    and on the CPU from the same draws (made here on the host): check 5.
    Where the two trees differ at a node (level order) that no earlier
    difference is above, the two chose different splits at a near tie: the
    node is named and its gain gap held to 1e-12 relative, and the nodes
    under it (in either tree) are left out.  Every other node: structure
    and thresholds equal, leaf statistics, gains and counts within 1e-9
    (the flipped nodes' counts and leaf statistics included); the
    predictions of the whole forests equal on the rows of 10,000 that pass
    through no flipped node.  The frontier is never capped at depth 8 with
    256 nodes, so a node's table id follows from its parent's alone and the
    nodes outside a flipped subtree line up."""
    import torch

    from spark_rapids_ml_torch import set_default_device
    from spark_rapids_ml_torch.classification import RandomForestClassificationModel
    from spark_rapids_ml_torch.ops import forest as pf
    from spark_rapids_ml_torch.ops.forest import TreeDraws
    from spark_rapids_ml_torch.regression import RandomForestRegressionModel

    rng = np.random.default_rng(seed)
    d, depth, B, T, K, A = 64, 8, 128, 3, 8, 256
    cent = rng.uniform(-4, 4, (10, d))
    blob = rng.integers(0, 10, n)
    X = cent[blob] + rng.normal(size=(n, d))
    w = rng.uniform(0.2, 2.0, n)
    y_reg = np.sin(X[:, 0]) + 0.5 * X[:, 1] * X[:, 2] + 0.1 * rng.normal(size=n)
    draws = [TreeDraws(rng.poisson(1.0, n).astype(np.float64),
                       [rng.gumbel(size=(min(1 << lv, A), d)) for lv in range(depth)])
             for _ in range(T)]
    Xq = X[:10_000]
    recs = []
    for label, crit, y, C in (("gini", pf.GINI, blob, 10), ("entropy", pf.ENTROPY, blob, 10),
                              ("variance", pf.VARIANCE, y_reg, 0)):
        out, secs = {}, {}
        for where, dev in (("card", device), ("cpu", torch.device("cpu"))):
            t0 = time.perf_counter()
            out[where] = pf.forest_fit(
                *(torch.from_numpy(np.asarray(a, np.float64)).to(dev) for a in (X, y, w)), 0,
                n_trees=T, max_depth=depth, n_bins=B, criterion=crit, n_classes=C,
                max_features=K, min_instances=1.0, min_info_gain=0.0, bootstrap=True,
                subsample=1.0, max_active=A, draws=draws)
            secs[where] = time.perf_counter() - t0
        card, cpu = out["card"], out["cpu"]
        rec = {"cell": f"(o) float64 {label} {n}x{d}", "card_s": secs["card"],
               "cpu_s": secs["cpu"], "flips": []}
        held = np.ones(card.feature.shape, bool)  # nodes held at 1e-9
        for t in range(T):
            differs = ((card.feature[t] != cpu.feature[t]) | (card.threshold[t] != cpu.threshold[t])
                       | (card.left_child[t] != cpu.left_child[t]))
            for i in np.flatnonzero(differs):
                if not held[t, i]:
                    continue  # under an earlier flip
                gap = abs(card.gain[t, i] - cpu.gain[t, i]) / max(abs(cpu.gain[t, i]), 1e-300)
                below = _below(card.left_child[t], cpu.left_child[t], int(i))
                rec["flips"].append({"tree": t, "node": int(i), "gain_gap_rel": float(gap),
                                     "nodes_below": len(below)})
                if gap > 1e-12:
                    raise AssertionError(f"(o) {label}: tree {t} differs at node {i} beyond a "
                                         f"near tie (gain gap {gap:.3e})")
                held[t, below] = False
        flipped = np.zeros_like(held)
        for f in rec["flips"]:
            flipped[f["tree"], f["node"]] = True
        rel = {}
        for k, mask in (("leaf_stats", held), ("gain", held & ~flipped), ("count", held)):
            a, b = getattr(card, k)[mask], getattr(cpu, k)[mask]
            rel[k] = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))
        rec.update({f"{k}_rel": v for k, v in rel.items()},
                   nodes_held=int(held.sum()), nodes=int(held.size))
        # rows through a flipped node: their leaf in the CPU's tree is that
        # node or under it (the nodes above a flip are equal in both trees)
        leaves = pf.forest_apply(torch.from_numpy(Xq), torch.from_numpy(cpu.feature).long(),
                                 torch.from_numpy(cpu.threshold),
                                 torch.from_numpy(cpu.left_child).long(), depth).numpy()
        rows = np.ones(len(Xq), bool)
        for f in rec["flips"]:
            t, i = f["tree"], f["node"]
            sub = [i] + _below(card.left_child[t], cpu.left_child[t], i)
            rows &= ~np.isin(leaves[t], sub)
        # each whole forest's transform on its own device
        preds = {}
        for where, dev, tr in (("card", device, card), ("cpu", "cpu", cpu)):
            attrs = dict(tr._asdict(), max_depth=depth, n_cols=d, dtype="float64")
            if C:
                attrs["num_classes"] = C
            model = (RandomForestClassificationModel if C else RandomForestRegressionModel)(**attrs)
            model._float32_inputs = False  # transform in float64
            set_default_device(dev)
            o = model.transform(Xq)
            preds[where] = (o["prediction"] if C else o)[rows]
        set_default_device(device)
        rec["rows_compared"] = int(rows.sum())
        rec["predictions_equal"] = bool(
            np.array_equal(preds["card"], preds["cpu"]) if C
            else np.max(np.abs(preds["card"] - preds["cpu"]), initial=0.0)
            <= 1e-9 * np.abs(preds["cpu"]).max(initial=0.0))
        log(f"  {rec['cell']}: card {secs['card']:.2f} s, CPU {secs['cpu']:.2f} s; near-tie flips "
            f"{rec['flips']}; on {rec['nodes_held']} of {rec['nodes']} nodes (all but those under "
            f"a flip) structure and thresholds equal, leaf_stats {rel['leaf_stats']:.3e}, gain "
            f"{rel['gain']:.3e}, count {rel['count']:.3e} relative (limit 1e-9); predictions on "
            f"the {rec['rows_compared']} of {len(Xq)} rows through no flipped node equal: "
            f"{rec['predictions_equal']}")
        if max(rel.values()) > 1e-9 or not rec["predictions_equal"]:
            raise AssertionError(f"(o) {label}: the card's forest differs from the CPU's")
        recs.append(rec)
    return {"cells": recs}


# (n): BASELINE.json configs[3]'s rows; its 100 trees cut to what the
# script's time allows (about 3.2 s a tree on an H100)
RF_N_ROWS, RF_N_TREES = 100_000_000, 4
# (l) grows 20 of the reference benchmark's 50 trees (phase 10's parquet
# fits took the minute the other 30 would)
RF_L_TREES = 20


def phase_forest(device, args, wide_X, wide_y) -> dict:
    """(l) the reference benchmark's random_forest_classifier_50t_d13 and
    (m) random_forest_regressor_30t_d6 on phase 5's (b) rows, 1M x 3000,
    (n) BASELINE.json's RandomForestClassifier on 100M x 64 (trees cut),
    (o) float64 card against CPU; then a classifier and a regressor saved
    and loaded."""
    import torch

    from spark_rapids_ml_torch.classification import (
        RandomForestClassificationModel,
        RandomForestClassifier,
    )
    from spark_rapids_ml_torch.regression import RandomForestRegressionModel, RandomForestRegressor

    cells = []
    torch.cuda.empty_cache()
    n, d = wide_X.shape
    t0 = time.perf_counter()
    Xl = torch.from_numpy(wide_X).to(device)
    yl = torch.from_numpy(wide_y).to(device)
    torch.cuda.synchronize()
    log(f"  (l), (m): phase 5's (b) rows {wide_X.shape} on the card: "
        f"{time.perf_counter() - t0:.2f} s")

    def rfc(**kw):
        return RandomForestClassifier(**{**dict(numTrees=RF_L_TREES, maxDepth=13,
                                                maxBins=128, seed=0), **kw})

    # the fit from a DeviceDataset grows RF_L_TREES of the 50 trees, the fit
    # from numpy 10 (the same first trees): a tree costs the same as in the
    # 50-tree fit, and the other trees would add a minute to the script
    cells.append(phase_forest_cell(device, f"(l) random_forest_classifier_50t_d13 {n}x{d}, "
                                   f"{RF_L_TREES} of its 50 trees", Xl,
                                   yl, rfc, wide_X, wide_y, 2, False, 2, args.seed + 71,
                                   1_000_000, numpy_trees=10))
    clf_model = cells[-1].pop("model")

    # (m): a label made from the seed, a nonlinear function of a few columns
    # plus noise, computed on the card
    gen = torch.Generator(device=device).manual_seed(args.seed + 72)
    ym = (2.0 * Xl[:, 0] + torch.sin(3.0 * Xl[:, 1]) + Xl[:, 2] * Xl[:, 3]
          + 0.5 * torch.randn(n, generator=gen, device=device))
    ym_host = ym.cpu().numpy()

    def rfr(**kw):
        return RandomForestRegressor(**{**dict(numTrees=30, maxDepth=6,
                                               maxBins=128, seed=0), **kw})

    cells.append(phase_forest_cell(device, f"(m) random_forest_regressor_30t_d6 {n}x{d}", Xl, ym,
                                   rfr, wide_X, ym_host, 0, False, 2, args.seed + 73,
                                   1_000_000, numpy_trees=10))
    # check 6: the DeviceDataset fit and the fit from numpy are two card fits
    # from one seed; the regression channels sum with atomics
    log(f"  (m): two card fits from one seed give equal trees: "
        f"{cells[-1]['numpy_fit_trees_equal']} (reported, not required)")
    reg_model = cells[-1].pop("model")
    X_keep = wide_X[:10_000]
    del Xl, yl, ym
    torch.cuda.empty_cache()

    # (n): phase 8's (h) rows again (standard normal, made on the card from
    # the same seed), labels from a seed-defined linear rule
    nn_ = RF_N_ROWS
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(args.seed)
    Xn = torch.randn((nn_, 64), generator=gen, device=device, dtype=torch.float32)
    a = torch.randn(64, generator=gen, device=device)
    yn = ((Xn @ a + 0.5 * torch.randn(nn_, generator=gen, device=device)) > 0).float()
    torch.cuda.synchronize()
    t_make = time.perf_counter() - t0
    t0 = time.perf_counter()
    Xn_host, yn_host = Xn.cpu().numpy(), yn.cpu().numpy()
    log(f"  (n) data {tuple(Xn.shape)} float32 made on the card {t_make:.2f} s, copied to the "
        f"host for the fit from numpy {time.perf_counter() - t0:.2f} s")

    def rfn(**kw):
        return RandomForestClassifier(**{**dict(numTrees=RF_N_TREES, maxDepth=16, seed=0),
                                         **kw})

    cells.append(phase_forest_cell(device, f"(n) RandomForestClassifier depth 16 {nn_}x64, "
                                   f"{RF_N_TREES} of BASELINE's 100 trees", Xn, yn, rfn,
                                   Xn_host, yn_host, 2, False, 1, args.seed + 74, 1_000_000))
    cells[-1].pop("model")
    del Xn, yn, Xn_host, yn_host
    torch.cuda.empty_cache()

    cells.extend(phase_forest_float64(device, 200_000, args.seed + 75)["cells"])

    with tempfile.TemporaryDirectory() as tmp:
        clf_model.save(os.path.join(tmp, "rfc"))
        reg_model.save(os.path.join(tmp, "rfr"))
        c2 = RandomForestClassificationModel.load(os.path.join(tmp, "rfc"))
        r2 = RandomForestRegressionModel.load(os.path.join(tmp, "rfr"))
    same = (np.array_equal(clf_model.transform(X_keep)["prediction"],
                           c2.transform(X_keep)["prediction"])
            and np.array_equal(reg_model.transform(X_keep), r2.transform(X_keep)))
    log(f"  the (l) and (m) models save + load; transform of {len(X_keep)} rows after load "
        f"identical: {same}")
    if not same:
        raise AssertionError("the loaded forest models answer differently")
    return {"cells": cells}


# ---- parquet and beyond the card's memory ---------------------------------------


def write_reference_parquet(path: str, X, y, slab: int = 50_000) -> None:
    """bench.py:900-931's layout: FixedSizeList float32 `features`, float64
    `label`, written in `slab`-row row groups (default compression)."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    n, d = X.shape
    writer = None
    try:
        for at in range(0, n, slab):
            t = pa.table({
                "features": pa.FixedSizeListArray.from_arrays(
                    pa.array(np.ascontiguousarray(X[at:at + slab]).reshape(-1)), d),
                "label": pa.array(np.asarray(y[at:at + slab], np.float64))})
            if writer is None:
                writer = pq.ParquetWriter(path, t.schema)
            writer.write_table(t)
    finally:
        if writer is not None:
            writer.close()


def write_list_parquet(path: str, X, y) -> None:
    """bench.py:470-476's layout (pandas' `list(X)`): a list<float>
    `features` column and a float64 `label`."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    n, d = X.shape
    offsets = pa.array(np.arange(0, n * d + 1, d, dtype=np.int32))
    feats = pa.ListArray.from_arrays(offsets, pa.array(X.reshape(-1)))
    pq.write_table(pa.table({"features": feats, "label": pa.array(np.asarray(y, np.float64))}),
                   path)


def decode_alone(path: str, d: int, parallel: bool, row_range=None) -> dict:
    """The parquet decode with no device work, the rate a fit from the file
    cannot beat: the fused pass's range readers (`parallel`), or the one
    scan of the streamed passes (`iter_chunks`), over `row_range`."""
    from spark_rapids_ml_torch import fused, streaming
    from spark_rapids_ml_torch import config as port_config

    n = streaming.parquet_row_count(path)
    # the decode itself: nothing recorded, nothing replayed
    port_config.set_config(chunk_cache="off")
    try:
        return _decode_alone(path, d, parallel, row_range, n)
    finally:
        port_config.set_config(chunk_cache="on")


def _decode_alone(path: str, d: int, parallel: bool, row_range, n: int) -> dict:
    from spark_rapids_ml_torch import fused, streaming

    t0 = time.perf_counter()
    nbytes = 0
    if parallel:
        rows = fused.fused_chunk_rows(n, d, 4)
        for cX, cy, cw in fused.iter_parquet_chunks(path, "features", (), "label", None, rows,
                                                    np.float32, label_dtype=np.float32):
            nbytes += (cX.shape[0] if cw is None else int((cw > 0).sum())) * d * 4
        readers = dict(fused.LAST_READER_DECISION)
    else:
        rows = min(streaming.chunk_rows_for(d, 4), n)
        for _, _, _, n_c in streaming.iter_chunks(path, "features", (), "label", None, rows,
                                                  np.float32, row_range=row_range):
            nbytes += n_c * d * 4
        readers = {"parquet_readers": 1, "parquet_readers_reason": "one scan", "readers_used": 1}
    s = time.perf_counter() - t0
    return {"seconds": s, "MB": nbytes / 1e6, "MBps": nbytes / 1e6 / s,
            "readers": readers.get("parquet_readers"), "readers_used": readers["readers_used"],
            "readers_reason": readers.get("parquet_readers_reason")}


def _pass_numbers(rep: dict) -> dict:
    """The numbers of the pass a parquet fit's route ran (fit_report())."""
    out = {"route": rep.get("route")}
    for key in ("fused", "stage", "streaming", "parquet_readers", "budget", "chunk_cache"):
        if key in rep:
            out[key] = {k: v for k, v in rep[key].items() if k != "stamp"}
    return out


def _parquet_fit(device, name: str, make, path: str, n: int, route: str, decode: dict) -> tuple:
    """(record, model) of one fit from the parquet path through the public
    entry point: seconds, rows/s, the route's pass numbers, the decode bound
    and the peak device memory; fails if the fit took another route."""
    import torch

    from spark_rapids_ml_torch import fused

    torch.cuda.empty_cache()
    fit_s, model, _ = _timed_fit(make, path, device)
    rec = {"cell": name, "rows": n, "fit_s": fit_s, "rows_per_s": n / fit_s,
           "peak_GB": torch.cuda.max_memory_allocated(device) / 1e9,
           "decode_bound_MBps": decode["MBps"], **_pass_numbers(model.fit_report())}
    p = rec.get("fused") or rec.get("stage") or rec.get("streaming") or {}
    rec["parquet_readers"] = readers = {k: v for k, v in fused.LAST_READER_DECISION.items()
                                        if k != "stamp"}
    log(f"  {name}: fit from parquet {fit_s:.3f} s ({rec['rows_per_s']:,.0f} rows/s), route "
        f"{rec['route']}; passes {p.get('passes', 1)}, chunks {p.get('chunks')}, host prep "
        f"{p.get('host_prep_s', 0):.3f} s, device {p.get('device_acc_s', 0):.3f} s, overlap "
        f"{p.get('overlap_s', 0):.3f} s; readers {readers.get('readers_used', 1)} "
        f"({readers.get('parquet_readers_reason', 'one scan')}); peak "
        f"device memory {rec['peak_GB']:.2f} GB; the decode alone {decode['MBps']:,.0f} MB/s")
    if rec["route"] != route:
        raise AssertionError(f"{name}: the fit took route {rec['route']}, not {route}")
    if model.fit_report().get("oom_fallback"):
        raise AssertionError(f"{name}: the fit ran out of device memory and took the streamed "
                             "retry")
    cache = rec.get("chunk_cache")
    if cache:
        log(f"    chunk cache: {cache_line(cache)}; ledger budget "
            f"{rec.get('budget', {}).get('budget_bytes', 0) / 1e9:.1f} GB, resident "
            f"{rec.get('budget', {}).get('resident_bytes', 0) / 1e9:.2f} GB")
    return rec, model


def cache_line(m: dict) -> str:
    """The chunk cache's counters and tier sizes, on one line."""
    return (f"fills {m.get('misses', 0)}, hits {m.get('hits', 0)}, hit "
            f"{m.get('hit_bytes', 0) / 1e9:.2f} GB, device tier "
            f"{m.get('device_bytes', 0) / 1e9:.2f} GB, host tier "
            f"{m.get('host_bytes', 0) / 1e9:.2f} GB (pinned "
            f"{m.get('pinned_bytes', 0) / 1e9:.2f}), spilled "
            f"{m.get('spilled_bytes', 0) / 1e9:.2f} GB in {m.get('spills', 0)} spills, "
            f"out-of-memory demotions {m.get('device_oom_demotions', 0)}, host copies "
            f"released {m.get('host_releases', 0)}, evictions {m.get('evictions', 0)}")


def _rel(a, b) -> float:
    """max |a - b| over max |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _hold(name: str, what: str, err: float, limit: float) -> dict:
    log(f"  {name}: {what}: {err:.3e} (limit {limit:g})")
    if not err <= limit:
        raise AssertionError(f"{name}: {what}: {err:.3e} beyond {limit:g}")
    return {what: err}


@contextlib.contextmanager
def capture(module, name: str, store: dict):
    """Keep the result of every `module.name(...)` call in `store[name]`
    while the block runs (the estimators import it at call time)."""
    orig = getattr(module, name)

    def wrapped(*a, **kw):
        out = orig(*a, **kw)
        store[name] = out
        return out

    setattr(module, name, wrapped)
    try:
        yield store
    finally:
        setattr(module, name, orig)


def phase_parquet_reference(device, tmp: str, X, y, path: str) -> list:
    """(p) the reference benchmark's 1M x 3000 input as parquet, fitted
    through the entry points (PCA k=3 and OLS on the fused pass from
    parquet, LogisticRegression and KMeans k=1000 on stage_parquet +
    _fit_array), each held against the same estimator fitted from the same
    rows in memory; (q) the streamed route on the same file (LinearRegression
    routed by hbm_bytes, PCA by force_streaming_stats), the statistics held
    against (p)'s and a float64 recomputation.  The rows take (e)'s three
    scaled columns while the phase runs.  The file stays at `path` for
    phase 11."""
    # (e)'s spectral gap (phase 6): three columns scaled by 16, 8 and 4, so
    # that the top three components are defined and the full solver of
    # (q) meets the randomized one of (p); undone (exactly) at the end
    scale = np.array([16.0, 8.0, 4.0], np.float32)
    X[:, :3] *= scale
    try:
        return _parquet_reference_cells(device, tmp, X, y, path)
    finally:
        X[:, :3] /= scale


def _parquet_reference_cells(device, tmp: str, X, y, path: str) -> list:
    import torch

    from spark_rapids_ml_torch import DeviceDataset, fused, streaming
    from spark_rapids_ml_torch import config as port_config
    from spark_rapids_ml_torch.classification import LogisticRegression
    from spark_rapids_ml_torch.clustering import KMeans
    from spark_rapids_ml_torch.feature import PCA
    from spark_rapids_ml_torch.regression import LinearRegression

    n, d = X.shape
    cells = []
    t0 = time.perf_counter()
    write_reference_parquet(path, X, y)
    t_write = time.perf_counter() - t0
    size = os.path.getsize(path)
    log(f"  (p) wrote {n} x {d} float32 rows + labels as parquet (50,000-row row groups): "
        f"{size / 1e9:.2f} GB in {t_write:.2f} s")
    dec_p = decode_alone(path, d, parallel=True)
    log(f"  (p) the decode alone, range readers: {dec_p['MB']:.0f} MB in {dec_p['seconds']:.2f} s "
        f"= {dec_p['MBps']:,.0f} MB/s ({dec_p['readers_used']} of {dec_p['readers']} readers: "
        f"{dec_p['readers_reason']})")

    # the in-memory references, from phase 5's rows on the card
    pca_kw, ols_kw = dict(k=3), dict(regParam=0.0, standardization=False)
    lr_kw = dict(regParam=1e-4, elasticNetParam=0.0, tol=1e-8, maxIter=200)
    km_kw = dict(k=1000, tol=1e-20, maxIter=30, initMode="random")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ds = DeviceDataset.from_host(X, y=y, dtype=np.float32, label_dtype=np.int32)
    ref64 = float64_stats(ds.X, ds.weight, ds.y.to(torch.float32))
    refs, ref_s = {}, {}
    for key, make in (("pca", lambda: PCA(**pca_kw).setInputCol("features")),
                      ("ols", lambda: LinearRegression(**ols_kw)),
                      ("logistic", lambda: LogisticRegression(**lr_kw)),
                      ("kmeans", lambda: KMeans(**km_kw))):
        ref_s[key], refs[key], _ = _timed_fit(make, ds, device)
    log("  (p) fits from the DeviceDataset: " + ", ".join(f"{k} {v:.3f} s"
                                                          for k, v in ref_s.items()))
    del ds
    torch.cuda.empty_cache()
    log(f"  (p) references from the rows in memory (DeviceDataset; PCA, OLS, LogisticRegression "
        f"maxIter=200, KMeans k=1000) and float64 statistics: {time.perf_counter() - t0:.2f} s")

    store: dict = {}
    with capture(fused, "fused_linreg_stats", store):
        rec, pca_p = _parquet_fit(device, f"(p) PCA k=3 {n}x{d} from parquet",
                                  lambda: PCA(**pca_kw).setInputCol("features"), path, n,
                                  "fused_parquet", dec_p)
        rec["fit_device_dataset_s"] = ref_s["pca"]
        rec["pr9_fit_s"] = 40.415  # PERF.md, PR 9, run 4
        for i, ps in enumerate(rec["fused"].get("pass_log", []), 1):
            log(f"    pass {i}: {ps['source']}, {ps['wall_s']:.3f} s, host prep "
                f"{ps['host_prep_s']:.3f} s, device {ps['device_acc_s']:.3f} s (PR 9: 11.2 s "
                "a pass, every pass a decode)")
        if [ps["source"] for ps in rec["fused"].get("pass_log", [])] != (
                ["decode"] + ["replay"] * 3):
            raise AssertionError(f"{rec['cell']}: passes 2-4 should replay the chunk cache")
        rec["check"] = hold_pca(rec["cell"], "vs the fit from the rows in memory", pca_p,
                                refs["pca"].components_,
                                refs["pca"].explained_variance_.astype(np.float64), 1e-4)
        cells.append(rec)
        rec, ols_p = _parquet_fit(device, f"(p) LinearRegression OLS {n}x{d} from parquet",
                                  lambda: LinearRegression(**ols_kw), path, n, "fused_parquet",
                                  dec_p)
    rec["fit_device_dataset_s"] = ref_s["ols"]
    rec["check"] = _hold(rec["cell"], "coefficients vs the fit from the rows in memory",
                         _rel(ols_p.coef_, refs["ols"].coef_), 1e-4)
    stats_p = store["fused_linreg_stats"]
    for k in ("gram", "sxy", "s1"):
        rec["check"].update(_hold(rec["cell"], f"fused statistics {k} vs float64",
                                  _rel(stats_p[k], ref64[k]), 1e-5))
    cells.append(rec)
    rec, lr_p = _parquet_fit(device, f"(p) LogisticRegression maxIter=200 {n}x{d} from parquet",
                             lambda: LogisticRegression(**lr_kw), path, n, "staged_parquet", dec_p)
    rec.update(iterations=lr_p.num_iters, iterations_in_memory=refs["logistic"].num_iters,
               fit_device_dataset_s=ref_s["logistic"])
    rec["check"] = _hold(rec["cell"], "objective vs the fit from the rows in memory",
                         abs(lr_p.objective - refs["logistic"].objective)
                         / abs(refs["logistic"].objective), 1e-5)
    cells.append(rec)
    rec, km_p = _parquet_fit(device, f"(p) KMeans k=1000 maxIter=30 {n}x{d} from parquet",
                             lambda: KMeans(**km_kw), path, n, "staged_parquet", dec_p)
    rec["fit_device_dataset_s"] = ref_s["kmeans"]
    rec["check"] = _hold(rec["cell"], "cost vs the fit from the rows in memory",
                         abs(km_p.inertia_ - refs["kmeans"].inertia_) / refs["kmeans"].inertia_,
                         1e-5)
    cells.append(rec)

    # (q): the streamed route, by the budget and by the flag
    # a budget of 0.8 x half the rows' bytes (at 1M x 3000: 4.8 GB, below 12 GB)
    port_config.set_config(hbm_bytes=n * d * 4 // 2)
    try:
        with capture(streaming, "linreg_streaming_stats", store):
            rec, ols_q = _parquet_fit(device, f"(q) LinearRegression OLS {n}x{d} streamed, by "
                                      "hbm_bytes", lambda: LinearRegression(**ols_kw), path, n,
                                      "streamed", dec_p)
    finally:
        port_config.reset_config()
    if rec["budget"]["forced"] or not rec["budget"]["over"]:
        raise AssertionError("(q): the budget, not the flag, should route the fit")
    stats_q = store["linreg_streaming_stats"]
    rec["check"] = _hold(rec["cell"], "coefficients vs (p)'s fused fit",
                         _rel(ols_q.coef_, ols_p.coef_), 1e-4)
    for k in ("gram", "sxy", "s1", "sw", "sy", "syy"):
        rec["check"].update(_hold(rec["cell"], f"streamed statistics {k} vs (p)'s",
                                  _rel(stats_q[k], stats_p[k]), 1e-5))
    cells.append(rec)
    port_config.set_config(force_streaming_stats=True)
    try:
        with capture(streaming, "pca_streaming_stats", store):
            rec, pca_q = _parquet_fit(device, f"(q) PCA k=3 {n}x{d} streamed, by "
                                      "force_streaming_stats",
                                      lambda: PCA(**pca_kw).setInputCol("features"), path, n,
                                      "streamed", dec_p)
    finally:
        port_config.reset_config()
    rec["check"] = hold_pca(rec["cell"], "vs (p)'s fit from parquet", pca_q, pca_p.components_,
                            pca_p.explained_variance_.astype(np.float64), 1e-4)
    for k, k64 in (("S", "gram"), ("s1", "s1"), ("sw", "sw")):
        rec["check"].update(_hold(rec["cell"], f"streamed moments {k} vs float64",
                                  _rel(store["pca_streaming_stats"][k], ref64[k64]), 1e-5))
    cells.append(rec)
    from spark_rapids_ml_torch.parallel import device_cache

    log(f"  (p)-(q) chunk cache: {cache_line(device_cache.chunk_metrics_snapshot())}")
    device_cache.clear_chunk_cache()
    torch.cuda.empty_cache()
    for c in cells:
        c.update(file_GB=size / 1e9, write_s=t_write)
    return cells


def phase_parquet_streaming(device, tmp: str, n: int, seed: int, path: str) -> list:
    """(r) bench.py:454-487's streaming cell: 2M x 64 float32 rows with a
    binary label as parquet (about 512 MB); LogisticRegression
    (regParam=1e-4, maxIter=10, tol=0) and KMeans k=20 fitted epoch by
    epoch under force_streaming_stats, each held against the in-memory fit
    of the same rows."""
    import torch

    from spark_rapids_ml_torch import DeviceDataset
    from spark_rapids_ml_torch import config as port_config
    from spark_rapids_ml_torch.classification import LogisticRegression
    from spark_rapids_ml_torch.clustering import KMeans
    from spark_rapids_ml_torch.ops import kmeans as km

    d = 64
    X, y = gen_binary(n, d, seed=6)
    t0 = time.perf_counter()
    write_list_parquet(path, X, y)
    log(f"  (r) bench.py's streaming input {n} x {d} float32 (_gen_binary(seed=6)) as parquet: "
        f"{os.path.getsize(path) / 1e6:.0f} MB in {time.perf_counter() - t0:.2f} s")
    dec_one = decode_alone(path, d, parallel=False)
    dec = decode_alone(path, d, parallel=True)
    log(f"  (r) the decode alone: one scan {dec_one['MB']:.0f} MB in {dec_one['seconds']:.2f} s = "
        f"{dec_one['MBps']:,.0f} MB/s; range readers ({dec['readers']}, the file's row groups "
        f"allowing {dec['readers_used']}) {dec['seconds']:.2f} s = {dec['MBps']:,.0f} MB/s")
    cells = []
    lr_kw = dict(regParam=1e-4, maxIter=10, tol=0.0)
    port_config.set_config(force_streaming_stats=True)
    try:
        rec, lr = _parquet_fit(device, f"(r) LogisticRegression {n}x{d} epoch-streamed",
                               lambda: LogisticRegression(**lr_kw), path, n, "streamed", dec)
        epochs = lr._get_model_attributes()["streaming_epochs"]
        rec.update(epochs=epochs, rows_per_s_per_epoch=n * epochs / rec["fit_s"],
                   iterations=lr.num_iters,
                   epoch_MBps=n * d * 4 * epochs / rec["fit_s"] / 1e6)
        log(f"  (r) LogisticRegression: {lr.num_iters} iterations, {epochs} epochs, "
            f"{rec['rows_per_s_per_epoch']:,.0f} rows/s per epoch "
            f"({rec['epoch_MBps']:,.0f} MB/s of features)")
        epoch_readings(rec, n, "(r) LogisticRegression")
        km_est = KMeans(k=20, seed=0, maxIter=20)
        rec_k, kmm = _parquet_fit(device, f"(r) KMeans k=20 {n}x{d} epoch-streamed",
                                  lambda: KMeans(k=20, seed=0, maxIter=20), path, n, "streamed",
                                  dec)
        rec_k.update(epochs=rec_k["streaming"]["epochs"], iterations=kmm.n_iter_,
                     rows_per_s_per_epoch=n * rec_k["streaming"]["epochs"] / rec_k["fit_s"])
        epoch_readings(rec_k, n, "(r) KMeans k=20")
    finally:
        port_config.reset_config()
    # the objective at the streamed coefficients, recomputed on the host in
    # float64 with the streamed fit's standardization (population std)
    mu = X.mean(axis=0, dtype=np.float64)
    pop_std = np.sqrt(np.maximum((X.astype(np.float64) ** 2).mean(axis=0) - mu * mu, 0.0))
    obj = float(host_objective(X, y, np.ones(n), lr.coef_, lr.intercept_, 1e-4, 0.0,
                               std=pop_std))
    rec["check"] = _hold(rec["cell"], "objective vs a float64 host recomputation",
                         abs(lr.objective - obj) / abs(obj), 1e-5)
    # the in-memory fit standardizes by the sample std (a scale of 1 + 1/(2n)
    # on every feature): with tol=0 and 10 iterations neither fit converges,
    # so the two trajectories part by more than rounding
    mem = LogisticRegression(**lr_kw).fit((X, y))
    rec["check"].update(_hold(rec["cell"], "objective vs the fit from the rows in memory",
                              abs(lr.objective - mem.objective) / abs(mem.objective), 1e-4))
    rec["check"].update(_hold(rec["cell"], "coefficients vs the fit from the rows in memory",
                              _rel(lr.coef_, mem.coef_), 1e-3))
    cells.append(rec)
    # the in-memory fit with the streamed fit's seeding rule: every
    # seed_sample_stride-th row (kmeans_fit_stepwise at the same init_rows)
    ds = DeviceDataset.from_host(X, dtype=np.float32)
    p = km_est._tpu_params
    _, cost, n_iter = km.kmeans_fit_stepwise(
        ds.X, ds.weight, k=20, seed=0, max_iter=20, tol=float(p["tol"]), init=str(p["init"]),
        init_steps=int(p.get("init_steps") or 2),
        oversample=float(p.get("oversampling_factor") or 2.0))
    # the cost only: on standard normal rows every centre has near-tie rows,
    # and the float32 atomics of the update flip some of them differently in
    # the two fits, so their centres part by more than rounding
    rec_k.update(iterations_in_memory=n_iter)
    rec_k["check"] = _hold(rec_k["cell"], "cost vs the in-memory fit from the same sample",
                           abs(kmm.inertia_ - float(cost)) / float(cost), 1e-5)
    cells.append(rec_k)
    del ds
    from spark_rapids_ml_torch.parallel import device_cache

    log(f"  (r) chunk cache: {cache_line(device_cache.chunk_metrics_snapshot())}")
    device_cache.clear_chunk_cache()
    torch.cuda.empty_cache()
    for c in cells:
        c["decode_one_scan_MBps"] = dec_one["MBps"]
    return cells


def epoch_readings(rec: dict, n: int, name: str) -> None:
    """The first scan (a decode that fills the chunk cache), the first
    epoch and the mean of the later ones (replays), in rows/s, beside PR
    9's 1.30 M rows/s per epoch (PERF.md, PR 9, run 4)."""
    st = rec["streaming"]
    ep = st.get("epoch_s", [])
    later = float(np.mean(ep[1:])) if len(ep) > 1 else float("nan")
    rec.update(scan_s=st.get("scan_s"), epoch1_s=ep[0] if ep else None, epoch_later_mean_s=later,
               epoch1_rows_per_s=n / ep[0] if ep else None,
               epoch_later_rows_per_s=n / later if later == later else None)
    log(f"  {name}: first scan (decode, fills the cache) {st.get('scan_s', 0):.3f} s = "
        f"{n / max(st.get('scan_s', 1e-9), 1e-9):,.0f} rows/s; epoch 1 {ep[0]:.4f} s = "
        f"{n / ep[0]:,.0f} rows/s; epochs 2-{len(ep)} mean {later:.4f} s = "
        f"{n / later:,.0f} rows/s (PR 9: 1.30 M rows/s an epoch, each a decode)")

def phase_parquet(device, args, wide_X, wide_y, tmp: str) -> dict:
    """Phase 10: (p) and (q) on phase 5's 1M x 3000 rows written as parquet,
    (r) bench.py's 2M x 64 streaming cell, in `tmp`; both files stay for
    phase 11."""
    import shutil

    du = shutil.disk_usage(tmp)
    log(f"  temporary directory {tmp}: {du.free / 1e9:.1f} GB free of {du.total / 1e9:.1f} GB")
    paths = {"p": os.path.join(tmp, "ref_1m_3k.parquet"), "r": os.path.join(tmp, "stream.parquet")}
    cells = phase_parquet_reference(device, tmp, wide_X, wide_y, paths["p"])
    cells += phase_parquet_streaming(device, tmp, args.r_rows, args.seed, paths["r"])
    return {"cells": cells, "paths": paths}


# ---- the chunk cache and the statistics ---------------------------------------


def _stats_equal(a: dict, b: dict) -> bool:
    return all(np.array_equal(np.asarray(a[k]), np.asarray(b[k])) for k in a)


def phase_epoch_cache(device, tmp: str) -> dict:
    """(s) bench.py:552-640's epoch-cache cell: `linreg_streaming_stats`
    six times over 400,000 x 64 float32 rows (host_batch_bytes = 16 MB:
    7 chunks), epoch 1 filling the cache and five replays of the device
    tier (their median the replay time); then six more with the ledger held
    full by a `reserve_external` claim, so that the replays come from the
    pinned host tier."""
    import torch

    from spark_rapids_ml_torch import config as port_config
    from spark_rapids_ml_torch import streaming
    from spark_rapids_ml_torch.parallel import device_cache

    n, d = 400_000, 64
    rng = np.random.default_rng(31)
    X = rng.standard_normal((n, d), dtype=np.float32)
    y = (X[:, 0] + 0.25 * rng.standard_normal(n) > 0).astype(np.float64)
    path = os.path.join(tmp, "epoch.parquet")
    write_list_parquet(path, X, y)
    X64 = X.astype(np.float64)
    ref = {"gram": X64.T @ X64, "sxy": X64.T @ y, "s1": X64.sum(axis=0)}
    del X64
    port_config.set_config(host_batch_bytes=16 * 1024 * 1024)
    rec = {"cell": f"(s) epoch cache, linreg_streaming_stats {n}x{d}", "rows": n}
    try:
        for tier in ("device", "host"):
            device_cache.clear_chunk_cache()
            held = 0
            if tier == "host":
                held = int(device_cache.cache_budget_bytes())
                if not device_cache.reserve_external("chip_smoke_hold", held):
                    raise AssertionError("(s): the ledger refused the hold")
            before = device_cache.chunk_metrics_snapshot()
            secs, stats = [], []
            for _ in range(6):
                torch.cuda.synchronize(device)
                t0 = time.perf_counter()
                stats.append(streaming.linreg_streaming_stats(path, "features", (), "label",
                                                              None, dtype=np.float32))
                secs.append(time.perf_counter() - t0)
            after = device_cache.chunk_metrics_snapshot()
            device_cache.release_external("chip_smoke_hold")
            hit_mb = (after["hit_bytes"] - before["hit_bytes"]) / 1e6
            chunks = streaming.STREAM_METRICS.get("chunks")
            replay = float(np.median(secs[1:]))
            rec[tier] = {"epoch_s": secs, "speedup": secs[0] / replay, "hit_MB": hit_mb,
                         "chunks": chunks, "replay_GBps": n * d * 4 / replay / 1e9,
                         "device_MB": after["device_bytes"] / 1e6,
                         "pinned_MB": after["pinned_bytes"] / 1e6,
                         "replay_equal": all(_stats_equal(stats[1], st) for st in stats[2:]),
                         "fill_equal": _stats_equal(stats[0], stats[1])}
            log(f"  (s) {tier} tier: epoch 1 {secs[0]:.4f} s, replays "
                + " / ".join(f"{t:.4f}" for t in secs[1:])
                + f" s (median {replay:.4f}), speedup {rec[tier]['speedup']:.1f}x, hit "
                f"{hit_mb:.0f} MB over {chunks} chunks, replay {rec[tier]['replay_GBps']:.2f} "
                f"GB/s of features; device tier {rec[tier]['device_MB']:.0f} MB, pinned "
                f"{rec[tier]['pinned_MB']:.0f} MB")
            if tier == "device" and after["device_bytes"] < n * d * 4:
                raise AssertionError("(s): the device tier should hold the stream")
            if tier == "host" and (after["device_bytes"] or after["pinned_bytes"] < n * d * 4):
                raise AssertionError("(s): the host tier should hold the stream, pinned")
            if not rec[tier]["replay_equal"] or not rec[tier]["fill_equal"]:
                raise AssertionError(f"(s) {tier}: the statistics of the epochs differ")
            for k in ref:
                rec.setdefault("check", {}).update(_hold(
                    rec["cell"], f"{tier} tier {k} vs float64", _rel(stats[-1][k], ref[k]), 1e-5))
    finally:
        device_cache.release_external("chip_smoke_hold")
        port_config.reset_config()
        device_cache.clear_chunk_cache()
        os.remove(path)
    return rec


def phase_duhl(device, path: str, n: int) -> list:
    """(t) DuHL on (r)'s file with host_batch_bytes = 16 MB (31 chunks):
    LogisticRegression (regParam=1e-4, maxIter=50, tol=1e-6) and KMeans k=20
    through the entry points on the streamed route, sampled and exact, held
    to the JAX package's DuHL test limits (tests/test_chunk_cache.py
    `test_duhl_logreg_convergence_parity`: coefficients 5e-3 relative,
    intercept 5e-3; `test_duhl_kmeans_convergence_parity`: cost 2%)."""
    from spark_rapids_ml_torch import config as port_config
    from spark_rapids_ml_torch.classification import LogisticRegression
    from spark_rapids_ml_torch.clustering import KMeans
    from spark_rapids_ml_torch.parallel import device_cache

    cells = []
    fits = {}
    for name, make in (("LogisticRegression", lambda: LogisticRegression(
            regParam=1e-4, maxIter=50, tol=1e-6)),
                       ("KMeans k=20", lambda: KMeans(k=20, seed=0, maxIter=50))):
        for mode in ("off", "duhl"):
            device_cache.clear_chunk_cache()
            port_config.set_config(force_streaming_stats=True, host_batch_bytes=16 * 1024 * 1024,
                                   streaming_chunk_sampling=mode)
            try:
                t0 = time.perf_counter()
                model = make().fit(path)
                secs = time.perf_counter() - t0
            finally:
                port_config.reset_config()
            st = model.fit_report()["streaming"]
            fits[(name, mode)] = model
            rec = {"cell": f"(t) {name} {n}x64 streamed, sampling {mode}", "fit_s": secs,
                   "epochs": st.get("epochs"), "sampled_epochs": st.get("sampled_epochs", 0),
                   "chunk_visits_saved": st.get("chunk_visits_saved", 0),
                   "chunks": st.get("chunks"), "epoch_s": st.get("epoch_s")}
            if name == "LogisticRegression":
                rec.update(objective=model.objective, iterations=model.num_iters)
            else:
                rec.update(cost=model.inertia_, iterations=model.n_iter_)
            log(f"  {rec['cell']}: {secs:.3f} s, {rec['epochs']} epochs, sampled "
                f"{rec['sampled_epochs']}, chunk visits saved {rec['chunk_visits_saved']}, "
                + (f"objective {model.objective:.9g}, {model.num_iters} iterations"
                   if name == "LogisticRegression"
                   else f"cost {model.inertia_:.9g}, {model.n_iter_} iterations"))
            cells.append(rec)
    exact, sampled = fits[("LogisticRegression", "off")], fits[("LogisticRegression", "duhl")]
    cf, cd = np.ravel(exact.coef_), np.ravel(sampled.coef_)
    cells[1]["check"] = _hold(cells[1]["cell"], "coefficients vs the exact fit (relative norm)",
                              float(np.linalg.norm(cf - cd) / np.linalg.norm(cf)), 5e-3)
    cells[1]["check"].update(_hold(cells[1]["cell"], "intercept vs the exact fit",
                                   float(np.max(np.abs(np.asarray(exact.intercept_)
                                                       - np.asarray(sampled.intercept_)))),
                                   5e-3))
    ke, ks = fits[("KMeans k=20", "off")], fits[("KMeans k=20", "duhl")]
    cells[3]["check"] = _hold(cells[3]["cell"], "cost vs the exact fit",
                              abs(ks.inertia_ - ke.inertia_) / ke.inertia_, 0.02)
    device_cache.clear_chunk_cache()
    return cells


def phase_summarize(device, p_path: str, p_rows: int, wide_X) -> list:
    """(u) bench.py:518-549's summarize cell and (p)'s file.  The eight
    metrics of the bench cell in one pass, then one pass per metric; the
    moments held against float64 numpy (1e-5), the distinct counts against
    the estimate of the numpy twin's registers.  Then the device metrics of
    (p)'s 12 GB file twice: the first call decodes and fills the cache, the
    second replays; the moments held against float64 (1e-5).  The
    quantiles of (p)'s 3000 columns (a host sketch) are left out: a pass of
    the sketch over 3000 columns costs minutes of host time."""
    import torch

    from spark_rapids_ml_torch.parallel import device_cache
    from spark_rapids_ml_torch.stats import STAT_METRICS, summarize
    from spark_rapids_ml_torch.stats import sketches

    cells = []
    n, d = 500_000, 32
    X = np.random.default_rng(11).standard_normal((n, d)).astype(np.float32)
    metrics = ["count", "mean", "variance", "min", "max", "normL2", "quantiles",
               "distinctCount"]
    summarize(X[:4096], metrics=metrics)  # the first call's one-time costs
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    got = summarize(X, metrics=metrics)
    fused_s = time.perf_counter() - t0
    fused_metrics = dict(STAT_METRICS)
    t0 = time.perf_counter()
    for m in metrics:
        summarize(X, metrics=[m])
    seq_s = time.perf_counter() - t0
    rec = {"cell": f"(u) summarize {n}x{d}, eight metrics", "rows": n, "fused_s": fused_s,
           "one_by_one_s": seq_s, "speedup": seq_s / fused_s,
           "rows_per_s": n / fused_s, "chunks": fused_metrics.get("chunks"),
           "overlap_fraction": fused_metrics.get("overlap_fraction")}
    log(f"  {rec['cell']}: one pass {fused_s:.3f} s ({n / fused_s:,.0f} rows/s, "
        f"{fused_metrics.get('chunks')} chunks, prep {fused_metrics.get('host_prep_s', 0):.3f} s, "
        f"device+sketches {fused_metrics.get('device_acc_s', 0):.3f} s), one by one "
        f"{seq_s:.3f} s, speedup {seq_s / fused_s:.2f}x")
    X64 = X.astype(np.float64)
    mean = X64.mean(axis=0)
    var = X64.var(axis=0, ddof=1)
    rec["check"] = _hold(rec["cell"], "mean vs float64", _rel(got["mean"], mean), 1e-5)
    rec["check"].update(_hold(rec["cell"], "variance vs float64", _rel(got["variance"], var),
                              1e-5))
    rec["check"].update(_hold(rec["cell"], "normL2 vs float64",
                              _rel(got["normL2"], np.sqrt((X64 * X64).sum(axis=0))), 1e-5))
    if not (np.array_equal(got["min"], X.min(axis=0)) and np.array_equal(got["max"],
                                                                         X.max(axis=0))):
        raise AssertionError("(u): min or max differ from numpy's")
    twin = sketches.hll_init(d, 12)
    sketches.hll_update(twin, X, np.ones(n, bool), 12)
    rec["check"].update(_hold(rec["cell"], "distinctCount vs the numpy twin's estimate",
                              _rel(got["distinctCount"], sketches.hll_estimate(twin["regs"])),
                              0.0))
    for q in (0.25, 0.5, 0.75):
        ranks = (X <= got["quantiles"][q][None, :]).mean(axis=0)
        rec["check"].update(_hold(rec["cell"], f"quantile {q} rank error",
                                  float(np.abs(ranks - q).max()), 0.02))
    del X64
    cells.append(rec)

    device_cache.clear_chunk_cache()
    dev_metrics = ["count", "mean", "variance", "min", "max", "normL2", "numNonZeros",
                   "distinctCount"]
    runs = []
    for i in range(2):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        res = summarize(p_path, metrics=dev_metrics)
        secs = time.perf_counter() - t0
        m = dict(STAT_METRICS)
        runs.append((secs, m, res))
        log(f"  (u) summarize (p)'s file, call {i + 1} ({m.get('source')}): {secs:.3f} s = "
            f"{p_rows / secs:,.0f} rows/s, prep {m.get('host_prep_s', 0):.3f} s, device "
            f"{m.get('device_acc_s', 0):.3f} s, {m.get('chunks')} chunks")
    if [r[1].get("source") for r in runs] != ["decode", "replay"]:
        raise AssertionError("(u): the second call should replay the first's stream")
    rec = {"cell": f"(u) summarize (p)'s {p_rows}x3000 file, eight device metrics",
           "rows": p_rows, "decode_s": runs[0][0], "replay_s": runs[1][0],
           "speedup": runs[0][0] / runs[1][0],
           "replay_device_s": runs[1][1].get("device_acc_s")}
    res = runs[1][2]
    # (p)'s rows are phase 5's (b) rows with (e)'s scaled columns
    scale = np.array([16.0, 8.0, 4.0], np.float32)
    X = wide_X
    X[:, :3] *= scale
    try:
        s1 = np.zeros(X.shape[1])
        s2 = np.zeros(X.shape[1])
        for lo in range(0, X.shape[0], 50_000):
            b = X[lo:lo + 50_000].astype(np.float64)
            s1 += b.sum(axis=0)
            s2 += (b * b).sum(axis=0)
        if res["count"] != X.shape[0]:
            raise AssertionError("(u): the count of (p)'s file")
        mins = X.min(axis=0)
        maxs = X.max(axis=0)
    finally:
        X[:, :3] /= scale
    mean = s1 / p_rows
    rec["check"] = _hold(rec["cell"], "mean vs float64", _rel(res["mean"], mean), 1e-5)
    rec["check"].update(_hold(rec["cell"], "variance vs float64", _rel(
        res["variance"], (s2 - p_rows * mean * mean) / (p_rows - 1)), 1e-5))
    rec["check"].update(_hold(rec["cell"], "normL2 vs float64", _rel(res["normL2"],
                                                                      np.sqrt(s2)), 1e-5))
    if not (np.array_equal(res["min"], mins) and np.array_equal(res["max"], maxs)):
        raise AssertionError("(u): min or max of (p)'s file differ from numpy's")
    for k in ("mean", "variance", "distinctCount"):
        if not np.array_equal(runs[0][2][k], res[k]):
            rec.setdefault("fill_vs_replay_differs", []).append(k)
    log(f"  (u) decode {runs[0][0]:.3f} s, replay {runs[1][0]:.3f} s, speedup "
        f"{rec['speedup']:.1f}x; the fill and the replay differ bit for bit in "
        f"{rec.get('fill_vs_replay_differs', [])} (range readers: another order)")
    cells.append(rec)
    device_cache.clear_chunk_cache()
    torch.cuda.empty_cache()
    return cells


def phase_cache_stats(device, tmp: str, paths: dict, p_rows: int, r_rows: int,
                      wide_X) -> dict:
    """Phase 11: (s), (t) and (u) on phase 10's files."""
    from spark_rapids_ml_torch.parallel import device_cache

    cells = [phase_epoch_cache(device, tmp)]
    cells += phase_duhl(device, paths["r"], r_rows)
    cells += phase_summarize(device, paths["p"], p_rows, wide_X)
    log(f"  chunk cache over the phase: {cache_line(device_cache.chunk_metrics_snapshot())}")
    return {"cells": cells}


# phase 12's sizes: (v) bench.py's cv_cached cell (bench.py:1956-1960), (w)
# the folds of its CrossValidator at the reference benchmark's width
CV_V_ROWS, CV_W_FOLDS = 400_000, 3


def _host_class_metrics(labels, preds) -> dict:
    """Accuracy, weighted precision and weighted recall recounted on the
    host in float64 from labels and predictions (unit weights)."""
    labels = np.asarray(labels, np.float64)
    preds = np.asarray(preds, np.float64)
    n = float(labels.size)
    prec = rec = 0.0
    for c in np.union1d(labels, preds):
        tp = float(np.sum((labels == c) & (preds == c)))
        n_label, n_pred = float(np.sum(labels == c)), float(np.sum(preds == c))
        prec += (tp / n_pred if n_pred else 0.0) * n_label / n
        rec += (tp / n_label if n_label else 0.0) * n_label / n
    return {"accuracy": float(np.sum(labels == preds)) / n, "weightedPrecision": prec,
            "weightedRecall": rec}


def _cv_run(device, build, df, mode: str) -> dict:
    """One CrossValidator fit with conf device_cache=`mode`: seconds,
    dataset stagings, peak card memory, the cache's decision, avgMetrics and
    bestIndex."""
    import torch

    from spark_rapids_ml_torch import config
    from spark_rapids_ml_torch.parallel.mesh import STAGE_COUNTS

    config.set_config(device_cache=mode)
    cv = build()
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    s0 = STAGE_COUNTS["dataset_stagings"]
    t0 = time.perf_counter()
    model = cv.fit(df)
    torch.cuda.synchronize(device)
    sec = time.perf_counter() - t0
    rep = model.fit_report()
    rec = {"path": "cached" if rep["used_cache"] else "legacy", "seconds": sec,
           "stagings": STAGE_COUNTS["dataset_stagings"] - s0,
           "peak_device_GB": torch.cuda.max_memory_allocated(device) / 1e9,
           "cache": rep["cache"], "fold_views": rep["fold_views"],
           "avgMetrics": [float(m) for m in model.avgMetrics],
           "bestIndex": int(model.bestIndex)}
    log(f"    {mode:>3}: {rec['path']} {sec:.3f} s, {rec['stagings']} stagings, peak "
        f"{rec['peak_device_GB']:.2f} GB, cache {rep['cache'].get('outcome')}, avgMetrics "
        f"{rec['avgMetrics']}, bestIndex {rec['bestIndex']}")
    return {"record": rec, "model": model}


def _hold_cv_pair(name: str, cached: dict, legacy: dict, rtol: float) -> float:
    """bestIndex equal on both paths and avgMetrics within `rtol`; returns
    the largest relative difference."""
    a = np.asarray(cached["avgMetrics"])
    b = np.asarray(legacy["avgMetrics"])
    rel = float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))
    if cached["bestIndex"] != legacy["bestIndex"]:
        raise AssertionError(f"{name}: bestIndex {cached['bestIndex']} cached, "
                             f"{legacy['bestIndex']} legacy")
    if rel > rtol:
        raise AssertionError(f"{name}: avgMetrics cached {a} against legacy {b}: {rel:.3e} > "
                             f"{rtol:g}")
    log(f"    held: bestIndex {cached['bestIndex']} on both paths, avgMetrics {rel:.3e} apart "
        f"(limit {rtol:g})")
    return rel


def phase_meta_cv_cached(device, n: int) -> dict:
    """(v) bench.py:1930-2010's cv_cached cell: n x 64 float32 from
    default_rng(17), LinearRegression, regParam grid [0, 0.1, 1], 3 folds,
    seed 11, rmse; the legacy path (a warm-up, then timed), the cached path
    cold and warm (a hit)."""
    import pandas as pd

    from spark_rapids_ml_torch.evaluation import RegressionEvaluator
    from spark_rapids_ml_torch.parallel import device_cache
    from spark_rapids_ml_torch.regression import LinearRegression
    from spark_rapids_ml_torch.tuning import CrossValidator, ParamGridBuilder

    d = 64
    rng = np.random.default_rng(17)
    X = rng.standard_normal((n, d)).astype(np.float32)
    y = (X @ rng.standard_normal((d,)).astype(np.float32)
         + 0.1 * rng.standard_normal(n).astype(np.float32))
    df = pd.DataFrame({"features": list(X), "label": y})

    def build():
        lr = LinearRegression()
        grid = ParamGridBuilder().addGrid(lr.regParam, [0.0, 0.1, 1.0]).build()
        return CrossValidator(estimator=lr, estimatorParamMaps=grid,
                              evaluator=RegressionEvaluator(metricName="rmse"), numFolds=3,
                              seed=11)

    device_cache.clear_device_cache()
    _cv_run(device, build, df, "off")  # warm-up
    legacy = _cv_run(device, build, df, "off")["record"]
    cold = _cv_run(device, build, df, "on")["record"]
    warm = _cv_run(device, build, df, "on")["record"]
    device_cache.clear_device_cache()
    if (cold["path"], warm["path"], legacy["path"]) != ("cached", "cached", "legacy"):
        raise AssertionError(f"(v): paths {cold['path']}, {warm['path']}, {legacy['path']}")
    if (cold["stagings"], warm["stagings"]) != (1, 0):
        raise AssertionError(f"(v): cached stagings {cold['stagings']} cold, "
                             f"{warm['stagings']} warm (want 1 and 0)")
    if warm["cache"].get("outcome") != "hit":
        raise AssertionError(f"(v): the warm run was no cache hit: {warm['cache']}")
    log(f"    held: cached stagings 1 cold, 0 warm (legacy {legacy['stagings']})")
    rel = max(_hold_cv_pair("(v) cold", cold, legacy, 1e-6),
              _hold_cv_pair("(v) warm", warm, legacy, 1e-6))
    return {"cell": f"(v) cv_cached {n}x{d} float32", "legacy": legacy, "cached_cold": cold,
            "cached_warm": warm, "avgMetrics_max_rel": rel,
            "speedup_cold": legacy["seconds"] / cold["seconds"],
            "speedup_warm": legacy["seconds"] / warm["seconds"]}


def phase_meta_wide(device, X, y, folds: int) -> dict:
    """(w) the reference benchmark's width: phase 5's (b) rows (1M x 3000
    float32, binary labels) and (b)'s Params; CrossValidator of
    LogisticRegression over regParam [1e-4, 1e-2], `folds` folds, seed 11,
    areaUnderROC, cached (mask views) and then legacy; fitMultiple of the two
    maps from the resident DeviceDataset against two separate fits
    (coefficients bit-equal); `evaluate` of the refit best model against a
    float64 host recount of its own predictions (1e-12)."""
    import pandas as pd
    import torch

    from spark_rapids_ml_torch.classification import LogisticRegression
    from spark_rapids_ml_torch.evaluation import BinaryClassificationEvaluator
    from spark_rapids_ml_torch.parallel import device_cache
    from spark_rapids_ml_torch.tuning import CrossValidator, ParamGridBuilder

    n, d = X.shape
    kw = dict(regParam=1e-4, elasticNetParam=0.0, tol=1e-8, maxIter=200)
    values = [1e-4, 1e-2]
    df = pd.DataFrame({"features": list(X), "label": y})
    row_bytes = d * 4 + 4 + 4
    log(f"    reckoned: X {n * d * 4 / 1e9:.2f} GB resident, reservation 3 x (X + labels + "
        f"weights) = {3 * n * row_bytes / 1e9:.2f} GB against the budget "
        f"{device_cache.cache_budget_bytes(device) / 1e9:.2f} GB, an eval view "
        f"{n / folds * d * 4 / 1e9:.2f} GB")

    def build():
        lr = LogisticRegression(**kw)
        grid = ParamGridBuilder().addGrid(lr.regParam, values).build()
        return CrossValidator(estimator=lr, estimatorParamMaps=grid,
                              evaluator=BinaryClassificationEvaluator(), numFolds=folds, seed=11)

    device_cache.clear_device_cache()
    run = _cv_run(device, build, df, "on")
    cached, model = run["record"], run["model"]
    if cached["path"] != "cached" or cached["stagings"] != 1:
        raise AssertionError(f"(w): cached run took {cached['path']}, {cached['stagings']} "
                             "stagings (want the cache and 1)")
    reserved, budget = cached["cache"]["reserved_bytes"], cached["cache"]["budget_bytes"]
    log(f"    cache reservation {reserved / 1e9:.2f} GB of a {budget / 1e9:.2f} GB budget")

    # the cached run's host side apart: the extraction of the frame, the
    # fingerprint and the staging (the fit report's record of them)
    est = LogisticRegression(**kw)
    t_extract = cached["cache"]["extract_s"]
    t_fp, t_stage = cached["cache"]["fingerprint_s"], cached["cache"]["stage_s"]
    log(f"    cached run's host side: extraction {t_extract:.3f} s, fingerprint {t_fp:.3f} s, "
        f"staging {t_stage:.3f} s")
    entry = next(iter(device_cache.get_device_cache()._entries.values()))

    # fitMultiple from the resident DeviceDataset against separate fits
    maps = [{est.regParam: v} for v in values]
    t0 = time.perf_counter()
    multi = dict(est.fitMultiple(entry.dataset, maps))
    t_multi = time.perf_counter() - t0
    t0 = time.perf_counter()
    alone = [est.fit(entry.dataset, m) for m in maps]
    t_alone = time.perf_counter() - t0
    coef_diff = max(float(np.max(np.abs(multi[i].coef_ - alone[i].coef_))) for i in range(2))
    if coef_diff != 0.0:
        raise AssertionError(f"(w): fitMultiple's coefficients differ from separate fits by "
                             f"{coef_diff:.3e}")
    log(f"    held: fitMultiple of 2 maps ({t_multi:.3f} s) bit-equal to 2 fits "
        f"({t_alone:.3f} s)")
    del multi, alone, entry
    device_cache.clear_device_cache()
    torch.cuda.empty_cache()

    # evaluate of the refit best model against a host recount
    t0 = time.perf_counter()
    summary = model.bestModel.evaluate(df)
    t_eval = time.perf_counter() - t0
    got = {"accuracy": summary.accuracy, "weightedPrecision": summary.weightedPrecision,
           "weightedRecall": summary.weightedRecall}
    want = _host_class_metrics(summary.predictions["label"].to_numpy(),
                               summary.predictions["prediction"].to_numpy())
    eval_err = max(abs(got[k] - want[k]) for k in want)
    if eval_err > 1e-12:
        raise AssertionError(f"(w): evaluate {got} against the host recount {want}")
    log(f"    held: evaluate ({t_eval:.3f} s) {got} within {eval_err:.1e} of the host recount")
    del summary, model

    legacy = _cv_run(device, build, df, "off")["record"]
    rel = _hold_cv_pair("(w)", cached, legacy, 1e-6)
    return {"cell": f"(w) CV LogisticRegression {n}x{d} float32, {folds} folds, grid 2",
            "cached": cached, "legacy": legacy, "avgMetrics_max_rel": rel,
            "speedup": legacy["seconds"] / cached["seconds"],
            "extract_s": t_extract, "fingerprint_s": t_fp, "stage_s": t_stage,
            "fit_multiple_s": t_multi, "separate_fits_s": t_alone,
            "fit_multiple_coef_diff": coef_diff, "evaluate_s": t_eval,
            "evaluate": got, "evaluate_err": eval_err, "reserved_bytes": reserved,
            "budget_bytes": budget}


def phase_meta(device, args, wide_X, wide_y) -> dict:
    """Phase 12: the meta layer, (v) and (w)."""
    import torch

    from spark_rapids_ml_torch import config
    from spark_rapids_ml_torch.parallel import device_cache

    # the earlier phases' confs, device tier and cached tensors go first
    config.reset_config()
    device_cache.clear_chunk_cache()
    device_cache.clear_device_cache()
    torch.cuda.empty_cache()
    log(f"  card memory allocated at the start: {torch.cuda.memory_allocated(device) / 1e9:.2f} GB")
    try:
        log(f"  (v) bench.py's cv_cached cell, {CV_V_ROWS} x 64")
        cells = [phase_meta_cv_cached(device, CV_V_ROWS)]
        log(f"  (w) CV at the reference benchmark's width, {wide_X.shape}, {CV_W_FOLDS} folds")
        cells.append(phase_meta_wide(device, wide_X, wide_y, CV_W_FOLDS))
    finally:
        config.reset_config()
        device_cache.clear_device_cache()
    return {"cells": cells}


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
    ap.add_argument("--h-rows", type=int, default=100_000_000)
    ap.add_argument("--j-rows", type=int, default=300_000)
    ap.add_argument("--k-rows", type=int, default=200_000)
    ap.add_argument("--k-dbscan-rows", type=int, default=20_000)
    ap.add_argument("--r-rows", type=int, default=2_000_000)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from spark_rapids_ml_torch import set_default_device

    t_start = time.perf_counter()

    def stage(msg: str) -> None:
        log(f"[{time.perf_counter() - t_start:.1f} s] {msg}")

    device = torch.device("cuda:0")
    set_default_device(device)

    stage("phase 1: card")
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
    # the parquet fits (ROADMAP.md section 1, item 1) read through pyarrow
    t0 = time.perf_counter()
    try:
        import pyarrow

        log(f"  import pyarrow {pyarrow.__version__}: {time.perf_counter() - t0:.3f} s")
    except ImportError:
        log("  pyarrow is not installed: the parquet fits cannot run on this machine")
    phase_build(args)

    stage("phase 2: kernels vs their plain versions on the card")
    phase_kernels_vs_plain(device, args.seed)

    stage(f"phase 3: main path, {args.items} x {args.dim} items, {args.queries} queries, "
          f"k={args.k}")
    main_out = phase_main_path(device, args)

    stage("phase 4: float64 path, a fifth of the items and queries; then the main shape")
    f64 = phase_float64_path(device, args)

    stage(f"phase 5: LogisticRegression: (a) bench.py's headline, (b) the reference benchmark's "
        "width, (c) softmax + OWL-QN + weights in float64")
    logistic = phase_logistic(device, args)

    stage(f"phase 6: PCA and LinearRegression: (d) PCA k=3 at bench.py's 1M x 128, (e) PCA k=3 "
        "and (f) LinearRegression at the reference benchmark's 1M x 3000, (g) float64 with "
        "weights, card against CPU")
    pca_linear = phase_pca_linear(device, args, logistic.pop("X_wide"))

    stage("phase 7: persistence")
    phase_persistence(main_out, logistic, pca_linear)

    stage(f"phase 8: KMeans and DBSCAN: (h) KMeans k=20 at BASELINE.json's 100M x 64, (i) the "
        "reference benchmark's kmeans_k1000_iter30 at 1M x 3000, (j) DBSCAN on bench.py's "
        "300k x 16 blobs, (k) float64, card against CPU")
    wide_X = pca_linear.pop("X_f")
    clustering = phase_clustering(device, args, wide_X)

    stage("phase 9: RandomForest: (l) the reference benchmark's random_forest_classifier_50t_d13"
          " and (m) random_forest_regressor_30t_d6 at 1M x 3000, (n) BASELINE.json's classifier "
          f"at {RF_N_ROWS} x 64 ({RF_N_TREES} trees), (o) float64, card against CPU")
    wide_y = logistic.pop("y_wide")
    forest = phase_forest(device, args, wide_X, wide_y)

    stage("phase 10: parquet: (p) the reference benchmark's 1M x 3000 input as parquet through "
          "the fused and staged routes, (q) the streamed route on it, (r) bench.py's 2M x 64 "
          "epoch-streaming cell")
    import shutil

    tmp = tempfile.mkdtemp(prefix="chip_smoke_parquet_")
    try:
        parquet = phase_parquet(device, args, wide_X, wide_y, tmp)
        stage("phase 11: chunk cache and stats: (s) bench.py's epoch-cache cell, (t) DuHL on "
              "(r)'s file, (u) summarize: bench.py's cell and (p)'s file")
        cache_stats = phase_cache_stats(device, tmp, parquet["paths"], wide_X.shape[0],
                                        args.r_rows, wide_X)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    stage("phase 12: the meta layer: (v) bench.py's cv_cached cell, (w) CrossValidator, "
          "fitMultiple and evaluate at the reference benchmark's width")
    meta = phase_meta(device, args, wide_X, wide_y)
    del wide_X, wide_y

    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"logistic": logistic["cells"]}))
    print(json.dumps({"pca_linear": pca_linear["cells"]}))
    print(json.dumps({"clustering": clustering["cells"]}))
    print(json.dumps({"forest": forest["cells"]}))
    print(json.dumps({"parquet": parquet["cells"]}, default=float))
    print(json.dumps({"cache_stats": cache_stats["cells"]}, default=float))
    print(json.dumps({"meta": meta["cells"]}, default=float))
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
