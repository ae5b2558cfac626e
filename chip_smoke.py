#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (spark_rapids_ml_torch) on one NVIDIA GPU.

Run from the root of a checkout:

    python3 chip_smoke.py [--seed 0] [--items 1000000] [--queries 10000]
                          [--dim 128] [--k 32] [--lr-rows 2000000] [--lr-dim 256]
                          [--lr-wide-rows 1000000] [--lr-wide-dim 3000]
                          [--lr-multi-rows 200000] [--pca-rows 1000000]
                          [--pca-dim 128] [--g-rows 200000] [--h-rows 100000000]
                          [--j-rows 300000] [--k-rows 200000] [--k-dbscan-rows 10000]
                          [--r-rows 2000000]

Phases, each of which makes the script exit non-zero when it fails:

1. card: the GPU's name and power limit, the torch and CUDA versions,
   whether pandas and pyarrow import (and their versions), the
   build of every CUDA kernel of the port from the sources in the checkout
   (nvcc, one process per source, all started together) and its time, each
   kernel's registers, spills and shared memory (ptxas), and the tensor-core
   instructions in the built library's SASS (cuobjdump): the float32 kernel
   must hold HGMMA (wgmma), the float64 kernel DMMA; and each kernel's
   local-memory loads and stores (LDL, STL), none in any of the float64
   small-q kernel's six instances; then the profiler's device time as the
   script reads it (`trace_device_us`) against `key_averages()` on one
   trace, equal to 1e-9;
2. kernels vs their plain versions, on the card: the split pass bit for
   bit; each main kernel against its plain version (both sides merged); the
   merge pass bit for bit in float32 and float64 at (S, k) = (5, 32),
   (8, 100) and (32, 1000), timed beside its plain version and torch.topk
   of the (q, S * k) view; the fused distance + top-k against its plain
   PyTorch twin at shapes with tails (k > valid items), invalid rows,
   exact ties (duplicated integer rows, also across the item splits),
   widths that are no multiple of the kernel's chunk (d = 17, 33, 131 and
   4100), k larger than a split's items, forced split counts, float32 and
   float64, and k = 1, 32 and 1000 (where the route takes a small-q
   kernel, the main kernel of the type is held on the case too); the
   small-q kernel, float32 and float64, against its plain version on
   `smallq_cases` (ragged n, invalid items, d = 6, 17, 33, 130, q = 1, 7,
   64 and 100, k = 1, 5, 32, forced splits, exact ties, signed zeros,
   tails), both sides' lists merged, ids equal but at ties (the type's
   tolerance), the integer cases bit for bit;
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
   DeviceDataset (cold, then one warm) and from host arrays
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
   10,000 rows of blobs, on the card and on the CPU.  Each KMeans cell:
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
   maxBins=128, bench.py:1013-1016; 2 of its 50 trees) and (m)
   random_forest_regressor_30t_d6
   (numTrees=30, maxDepth=6, maxBins=128, a label made from the seed; 2
   of its 30 trees) on
   phase 5's (b) rows, 1,000,000 x 3000; (n) BASELINE.json's classifier
   (maxDepth=16, bench.py:221-224) on (h)'s 100,000,000 x 64 standard
   normal rows with a linear label, its 100 trees cut to 1;
   (o) float64 with weights in [0.2, 2), bootstrap and a feature subset
   (gini, entropy and variance) on 100,000 x 64, card against CPU.  Each of (l)-(n): fits
   from a DeviceDataset and from numpy (1 tree: the same first tree), a
   transform of 1,000,000 rows, the
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
   directory (its free space printed first; about 7 GB of disk): (p) the
   first 500,000 (`PARQUET_ROWS`) of phase 5's (b) rows and labels, x 3000
   float32, with (e)'s three scaled columns, written in bench.py:900-931's
   layout (FixedSizeList, 50,000-row row groups, about 6 GB); the decode alone
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
   distinctCount of (p)'s 6 GB file twice (a decode, then a replay), the
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

13. ApproximateNearestNeighbors through the public entry points (torch
   ops, no hand-written kernel of its own; the fused kernel gives the
   exact ground truth and `umap_knn_graph`'s euclidean branch): (x)
   BASELINE.json configs[4], 10,000,000 x 128 float32 blobs of 100 centres
   made on the card, the first 10,000 rows as queries, k = 10: the exact
   ground truth (NearestNeighbors, timed; the fused function's kernel
   entry at this shape), IVF-Flat (nlist sqrt(n), nprobe 20; recall held
   above tests/test_ann.py's 0.85) and IVF-PQ (M 8, n_bits 8, refine 2;
   recall recorded), each with its build by part, the index's upload, a
   first and a warm kneighbors (queries/s) and the warm search's parts
   (probe, fold, host re-rank); (y) CAGRA, graph_degree 32, on the first
   1,000,000 of (x)'s rows (recall recorded), and bench.py:255-303's
   bench_ann cell, 200,000 x 64 blobs of 100 centres: CAGRA (held at
   0.95), IVF-Flat nlist 448, nprobe 20 (held at 0.85) and IVF-PQ with 16
   subspaces and refine 4 (held at 0.7), each CAGRA build by NN-descent
   round and one more round by part; (z) on that data: IVF-Flat with
   every list probed against the fused kernel's ids (ties aside), cosine
   on IVF-Flat (0.85) and CAGRA (0.9) with 1 - cos within 2e-3, save,
   load and kneighbors bit-equal, `umap_knn_graph` euclidean against the
   plain blocked form and manhattan against cdist(p=1) + top-k.

14. UMAP through the public entry points (torch ops; the fused kernel
   gives its brute-force graph and every transform's neighbours), on (x)'s
   host rows before they are freed: (aa) BASELINE.json configs[4]: a
   tenth of the 10M x 128 rows (about 1M, the reference fits UMAP on one
   worker's sample), n_neighbors 15, build_algo "auto" (NN-descent),
   200 epochs, spectral init, random_state 0: the fit's seconds by part
   (sampling, staging, the kNN graph, smooth_knn_dist, the fuzzy set,
   find_ab_params, the init's host SVD, the SGD with ms an epoch against
   its bytes bound and the form chosen), a transform of 10,000 held-out
   rows (queries/s), and trustworthiness on 5,000 of the fit's rows held
   at UMAP_TRUST_FLOOR; (bb) bench.py:814-860's bench_umap cells, 100,000
   x 32 standard normal rows and 100 epochs, 1,000,000 x 32 and 50, no
   random_state: the measured probe's verdict and both warm epoch times;
   (cc) the fused kernel on UMAP's path: a brute-force fit of 50,000 of
   (x)'s rows (k = 16, items = queries) and (aa)'s transform at
   n_neighbors 40, which launches the k > 32 merge
   (`merge_partials_kernel<float>`): the launches counted, each kernel held
   against its plain version (on the blobs every differing id slot a tie,
   the share recorded; at the same shapes on standard normal rows ids
   equal on 99.9% of slots), the merge bit for bit and its device time
   from a CUDA graph; (dd) a float64
   fit on the card against the CPU (2,000 x 16, the same draws handed to
   both: the optimizer's inputs within 1e-12, its result within 1e-9),
   two random_state=0 fits bit-equal, a CSR fit against the dense fit of
   the same rows (1e-6), save and load bit-equal, a cosine fit.
15. sparse LogisticRegression and the resilience layer (torch ops, no
   hand-written kernel): (ee) 10,000,000 rows x 2^18 columns (HashingTF's
   default numFeatures) in the Criteo display-ads layout (13 integer
   fields present with probability 0.8, 26 categorical fields, each field
   hashed into its own column range; labels from a planted sparse weight
   vector, a quarter positive), made on the card from --seed and fetched
   as canonical CSR, fitted through the ELL route (regParam 1e-6,
   maxIter 100, tol 1e-6, standardization): the host CSR -> ELL, the
   staging, the column layout, the moments, the oracle per evaluation
   beside its bytes bound, ms an L-BFGS iteration, iterations and fit
   seconds; two fits of the same rows (the entry point's, the staged
   rows' with checkpoint_dir) bit-equal, the checkpoint's cost; the objective against a float64 fit on the card and against a
   float64 evaluation at the model (1e-5); 10,000 held-out rows
   transformed (rows/s, AUC); OWL-QN (elasticNetParam 1) on the first
   1,000,000 rows, its objective against a float64 evaluation.  (ff) 5
   classes on the first 1,000,000 rows (labels from a quarter of planted
   margins plus Gumbel noise), the objective against its float64
   evaluation (1e-5).  (gg) on those 1,000,000 rows: a preemption
   injected at iteration 10 retried within the fit and a fit killed there
   resumed by a new estimator, both bit-equal to the uninterrupted fit; a
   real device-side assert at iteration 10 in a child process, classified
   as a device loss, and a second child resuming from the checkpoint
   bit-equal (the children run beside the parent's other work); KMeans
   k=20 on 10,000,000 x 64 rows of (h)'s generator resumed after an
   injected preemption at iteration 5 (index_add_'s atomics keep two
   uninterrupted fits from being bit-equal: the resumed centres are held
   within 10 times their distance, the cost within 1e-5); the watchdog (a
   deadline a quarter of the 1M-row fit's time: DispatchTimeout within
   the deadline + 2 s, then a fit that waits for the abandoned one); a
   real torch.cuda.OutOfMemoryError in the transform (ballast leaves less
   than one chunk free) recovered by halving, the predictions equal.
16. serving through the public entry points (serving/: host code and
   torch ops; the served kNN route runs the fused kernel): (hh) bench.py's
   bench_serving at full width — a LogisticRegression fitted on 100,000
   rows x 3000 of (b)'s rows, PCA k=3 on phase 3's 1M x 128 items and
   NearestNeighbors k=32 over them (phase 3's model, registered with its
   `_search`), and a float64 NearestNeighbors k=32 (float32_inputs=False)
   fitted on the float64 copy of those items (`knn64`, registered with
   dtype float64), 300 one-row requests a model, sequential transforms against
   the coalescing server: queries/s, p50/p99 ms, batches, the speedup, the
   card's idle share from the serving utilization timeline, each served
   slice held against the model's own transform of the same rows; the
   fused kernel's launch counts reset before and read after each served kNN
   run (one small-q kernel launch a batch; knn64: the float64 small-q
   kernel at least once a batch and the float64 main kernel never), and
   the fused function timed at
   the served batch sizes q = 1, 8 and 64 through its route (the small-q
   kernel and the merge, each also alone on the card, and the route by
   split count) and through the 3xTF32 route, beside its bound, its plain
   version and torch.matmul + torch.topk, held against the twin and the
   small-q route against the 3xTF32 route (ids equal but at ties, d^2
   1e-4); both float32 routes swept over q (SMALLQ_SWEEP), the sweep that
   set fused_knn._SMALL_Q; the float64 function at the same sizes on
   knn64's staged items through its route (the float64 small-q kernel and
   the merge, each also alone on the card) and through the float64
   main-kernel route called directly, beside its bound, its plain version
   and torch.matmul + torch.topk in float64, both held against the plain
   version (ids equal but at ties, d^2 1e-10); both float64 routes swept
   over q, the sweep that set fused_knn._SMALL_Q_F64.
   (ii) bench_serving_scale's 200 pinned d = 64 models (a
   LogisticRegression, a PCA and a kNN fanned out), 2,000 one-row requests
   4:1 interactive:batch, queued while paused and drained at depth 1 and
   at the auto depth: aggregate queries/s, the worst p99, interactive
   drops (must be 0), outputs byte-equal across the depths.  (jj) an
   injected serving_dispatch OOM and a serving_collect transient at depth
   3 (every request answered once, exactly), then bench_serving_control's
   brownout cut to 10 s windows: batch shed before interactive, the phase
   back to normal.

The last lines of standard output are a JSON object of the logistic
cells' numbers, one of the PCA and LinearRegression cells' numbers, one
of the clustering cells' numbers, one of the forest cells' numbers
({"forest": [...]}), one of the parquet cells' numbers
({"parquet": [...]}), one of the chunk cache and statistics cells'
numbers ({"cache_stats": [...]}), one of the meta layer's cells
({"meta": [...]}), one of the ANN cells ({"ann": [...]}), one of the
UMAP cells ({"umap": [...]}), one of phase 15's cells ({"sparse": [...]}),
one of phase 16's ({"serving": [...]}), a JSON object of the kernels'
numbers (phase 13 adds the float32 fused function at (x)'s shape, phase 14
the fused function at UMAP's two shapes and the k > 32 merge, phase 16
the small-q kernel at the served batch sizes, the 3xTF32 route's time
beside it, and the float64 small-q kernel at the same sizes, the float64
main-kernel route's time beside it),
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
            "merge_partials_regs_kernel", "fused_knn_f64_kernel", "fused_knn_smallq_kernel",
            "fused_knn_smallq_f64_kernel")
# template arguments as the Itanium ABI mangles them (an int N as LiNE)
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
            while True:
                tok = next((t for t in _TEMPLATE_ARGS if rest.startswith(t)), None)
                num = re.match(r"Li(\d+)E", rest)
                if tok:
                    args.append(_TEMPLATE_ARGS[tok])
                    rest = rest[len(tok):]
                elif num:
                    args.append(num.group(1))
                    rest = rest[num.end():]
                else:
                    break
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
    """Tensor-core instructions (HGMMA, HMMA, DMMA) and local-memory loads
    and stores (LDL, STL: spills, or an array the compiler could not keep
    in registers) in each kernel of a built library, from `cuobjdump
    -sass`."""
    exe = Path(nvcc).parent / "cuobjdump"
    sass = subprocess.run([str(exe), "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    out = {}
    for chunk in sass.split("Function : ")[1:]:
        name = _kernel_of(chunk.split(None, 1)[0])
        out[name] = {op: len(re.findall(rf"\b{op}\b", chunk))
                     for op in ("HGMMA", "HMMA", "DMMA", "LDL", "STL")}
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


def compare_ties_aside(name, kd, ki, td, ti, X, Q, exact: bool) -> float:
    """Hold (kd, ki) against (td, ti) where a case has too few id slots for
    `compare`'s share of equal slots (one swapped near tie at q = 1 is 2 of
    32): exact cases bit for bit (`compare`); else the same +inf/-1 tails,
    every finite d^2 within rtol * max(1, d^2) (rtol by dtype, `_RTOL`:
    1e-4 in float32, 1e-10 in float64), and every id slot that differs a
    tie: both items at float64 squared distances from the query within that
    tolerance of each other."""
    if exact:
        return compare(name, kd, ki, td, ti, exact=True)
    rtol = _RTOL[str(td.dtype)]
    kd, td = kd.cpu().double().numpy(), td.cpu().double().numpy()
    ki, ti = ki.cpu().numpy(), ti.cpu().numpy()
    fin = np.isfinite(td)
    if not np.array_equal(fin, np.isfinite(kd)) or not np.array_equal(ki < 0, ti < 0):
        raise AssertionError(f"{name}: +inf/-1 tails differ")
    err = float(np.abs(kd[fin] - td[fin]).max()) if fin.any() else 0.0
    tol = rtol * np.maximum(1.0, np.abs(td))
    if not (np.abs(kd[fin] - td[fin]) <= tol[fin]).all():
        raise AssertionError(f"{name}: d2 differs beyond {rtol:g} * max(1, d2)")
    X, Q = np.asarray(X, np.float64), np.asarray(Q, np.float64)
    for i, j in np.argwhere(ki != ti):
        a = ((X[ki[i, j]] - Q[i]) ** 2).sum()
        b = ((X[ti[i, j]] - Q[i]) ** 2).sum()
        if abs(a - b) > tol[i, j]:
            raise AssertionError(f"{name}: query {i} slot {j}: id {ki[i, j]} at {a} against "
                                 f"{ti[i, j]} at {b}: not a tie")
    log(f"  {name}: max|d2 - d2 reference| = {err:.3e}, id slots equal = "
        f"{float((ki == ti).mean()):.6f}, every other slot a tie")
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


def smallq_cases(seed: int) -> list:
    """(name, items, valid, queries, k, exact, splits) of the small-q kernel
    against its plain version, as numpy arrays: ragged n (no whole tile of
    256 items), invalid items inside the set and at the tail, d = 6, 17, 33
    and 130 (no whole 32-float chunk; 6, 17 and 33 take 4-byte copies), q =
    1, 7 and 64, k = 1, 5 and 32, forced split counts; then q = 100 (two
    query blocks), and exact cases: integer rows repeated (ties broken by
    position, also across splits), signed zeros, fewer valid items than k,
    fewer items than k.  splits None: the wrapper's choice."""
    rng = np.random.default_rng(seed + 18)
    cases = []
    split_cycle = (None, 1, 3, 7)
    i = 0
    for d in (6, 17, 33, 130):
        for q in (1, 7, 64):
            for k in (1, 5, 32):
                n = 1000 + 37 * i
                v = np.ones(n)
                v[::7] = 0.0
                v[-50:] = 0.0
                cases.append((f"small-q n={n} d={d} q={q} k={k}", rng.normal(size=(n, d)), v,
                              rng.normal(size=(q, d)), k, False, split_cycle[i % 4]))
                i += 1
    cases.append(("small-q q=100 (two query blocks) k=32", rng.normal(size=(3000, 40)),
                  np.ones(3000), rng.normal(size=(100, 40)), 32, False, None))
    Xi = rng.integers(-3, 4, size=(1500, 17)).astype(np.float64)
    Xi[750:] = Xi[:750]  # every row twice, 750 positions apart: ties across splits
    for q, s in ((7, 3), (64, None)):
        cases.append((f"small-q exact ties q={q} k=32", Xi, np.ones(1500),
                      rng.integers(-3, 4, size=(q, 17)).astype(np.float64), 32, True, s))
    Xz = rng.integers(-2, 3, size=(600, 8)).astype(np.float64)
    Xz[Xz == 0] = -0.0
    Xz[::3] = np.abs(Xz[::3])  # +0.0 and -0.0 in the same columns
    Qz = rng.integers(-2, 3, size=(5, 8)).astype(np.float64)
    Qz[Qz == 0] = -0.0
    cases.append(("small-q signed zeros q=5 k=5", Xz, np.ones(600), Qz, 5, True, 2))
    v = np.zeros(300)
    v[:4] = 1.0
    cases.append(("small-q tails k>valid q=10 k=7", rng.integers(-3, 4, size=(300, 6)), v,
                  rng.integers(-3, 4, size=(10, 6)), 7, True, None))
    cases.append(("small-q fewer items than k q=3 k=32", rng.integers(-3, 4, size=(20, 33)),
                  np.ones(20), rng.integers(-3, 4, size=(3, 33)), 32, True, None))
    return cases


def smallq_kernel(dtype):
    """(wrapper, launch count, query block) of the small-q kernel of
    `dtype` (torch.float32 or torch.float64)."""
    import torch

    from spark_rapids_ml_torch.ops import fused_knn as fk

    if dtype == torch.float64:
        return fk.fused_knn_smallq_f64, fk.SMALLQ_F64_LAUNCHES, fk._SQ_QBLOCK_F64
    return fk.fused_knn_smallq, fk.SMALLQ_LAUNCHES, fk._SQ_QBLOCK


def phase2_smallq(device, seed: int) -> None:
    """The small-q kernel, float32 and float64, against its plain version
    (one for both types) on `smallq_cases`: each side's (q, S, k) lists
    merged by the plain merge (a list past the row's merged top-k depends
    on the order the blocks ran), held by `compare_ties_aside` at the
    type's tolerance."""
    import torch

    from spark_rapids_ml_torch.ops import fused_knn as fk

    cases = smallq_cases(seed)
    for dt in (torch.float32, torch.float64):
        run, before, qblock = smallq_kernel(dt)
        for name, X, v, Q, k, exact, splits in cases:
            Xt, vt, Qt = (torch.as_tensor(a, dtype=dt, device=device).contiguous()
                          for a in (X, v, Q))
            s = splits or fk.smallq_splits(Xt.shape[0], Qt.shape[0],
                                           fk.smallq_wave(device, Qt.shape[0], dt), qblock)
            part_d, part_i = run(Xt, vt, Qt, k, s)
            pd, pi = fk.fused_knn_smallq_reference(Xt, vt, Qt, k, s)
            torch.cuda.synchronize()
            if part_d.shape != pd.shape:
                raise AssertionError(f"{name}: lists {tuple(part_d.shape)} != {tuple(pd.shape)}")
            q2 = (Qt * Qt).sum(dim=1)
            compare_ties_aside(f"{str(dt)[6:]} {name} S={part_d.shape[1]}",
                               *fk.merge_partials_reference(part_d, part_i, q2, k),
                               *fk.merge_partials_reference(pd, pi, q2, k), X, Q, exact)
        launched = smallq_kernel(dt)[1] - before
        if launched != len(cases):
            raise AssertionError(f"{len(cases)} small-q {dt} cases launched the kernel "
                                 f"{launched} times")


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

    phase2_smallq(device, seed)

    def counts():
        return {"fused_knn_tf32": fk.LAUNCHES, "fused_knn_smallq": fk.SMALLQ_LAUNCHES,
                "fused_knn_f64": fk.LAUNCHES_F64, "fused_knn_smallq_f64": fk.SMALLQ_F64_LAUNCHES}

    before = counts()
    want = dict.fromkeys(before, 0)
    cases = phase2_cases(seed)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for name, X, v, Q, k, dt, exact, splits in cases:
        dt = getattr(torch, dt)
        Xt = torch.as_tensor(X, dtype=dt, device=device).contiguous()
        vt = torch.as_tensor(v, dtype=dt, device=device)
        Qt = torch.as_tensor(Q, dtype=dt, device=device).contiguous()
        kd, ki = fk.fused_topk_sqdist(Xt, vt, Qt, k, splits=splits)
        td, ti = fk.fused_topk_sqdist_reference(Xt, vt, Qt, k)
        torch.cuda.synchronize()
        compare(name, kd, ki, td, ti, exact)
        kernel = fk.route(Qt.shape[0], k, dt)
        want[kernel] += 1
        if kernel in ("fused_knn_smallq", "fused_knn_smallq_f64"):
            # the route took a small-q kernel: the main kernel of the type
            # is held on the same case through its own entry
            s = splits or fk.auto_splits(Xt.shape[0], Qt.shape[0], k, sms, dt)
            if dt == torch.float64:
                main = "fused_knn_f64"
                parts = fk.fused_knn_f64(Xt, Qt, fk.padded_item_norms(Xt, vt), k, s)
            else:
                main = "fused_knn_tf32"
                parts = fk.topk_partials(Xt, vt, Qt, k, s)
            want[main] += 1
            kd, ki = fk.merge_partials(*parts, (Qt * Qt).sum(dim=1), k)
            torch.cuda.synchronize()
            compare(f"{name} ({main} main kernel)", kd, ki, td, ti, exact)
    got = {name: n - before[name] for name, n in counts().items()}
    if got != want:
        raise AssertionError(f"phase 2's cases should launch the main and small-q kernels "
                             f"{want} times; they launched them {got} times")


def reset_counts() -> None:
    from spark_rapids_ml_torch.ops import fused_knn as fk

    fk.LAUNCHES = fk.SMALLQ_LAUNCHES = fk.LAUNCHES_F64 = fk.SMALLQ_F64_LAUNCHES = 0
    fk.SPLIT_LAUNCHES = fk.MERGE_LAUNCHES = 0


def library_topk(items_t, queries_t, k: int, block: int = 1024):
    """The yardstick: one blocked torch.matmul + torch.topk computing the
    same function (`block` queries a block), IEEE arithmetic."""
    import torch

    x2 = (items_t * items_t).sum(1)
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for q0 in range(0, queries_t.shape[0], block):
            Qb = queries_t[q0 : q0 + block]
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


def _chunk_map(fn, X) -> list:
    """`fn` of each row chunk of X (`_host_rows`), in chunk order, computed
    on 4 host threads (numpy's conversions and products run without the
    interpreter lock); summing the list in order gives the serial loop's
    result bit for bit."""
    import concurrent.futures

    with concurrent.futures.ThreadPoolExecutor(4) as ex:
        return list(ex.map(fn, _host_rows(X)))


def host_moments(X, w):
    """Weighted mean and ddof-1 std of X's columns in float64 on the host,
    two passes over row chunks (std 0 -> 1, as the estimator does)."""
    wsum = w.sum()
    mean = sum(_chunk_map(lambda r: w[r] @ X[r].astype(np.float64), X)) / wsum
    var = sum(_chunk_map(lambda r: w[r] @ (X[r].astype(np.float64) - mean) ** 2, X))
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

    def chunk(r):
        """(loss, gradient of the coefficients, of the intercepts) of rows r"""
        x = X[r].astype(np.float64)
        m = x @ coef.T + intercept
        wr = w[r] / wsum
        if binomial:
            s = 2.0 * y[r] - 1.0
            z = -s * m[:, 0]
            part = (np.logaddexp(0.0, z) * wr).sum()
            res = (-s / (1.0 + np.exp(-z)) * wr)[:, None]
        else:
            lse = np.logaddexp.reduce(m, axis=1)
            lab = y[r].astype(np.int64)
            part = ((lse - m[np.arange(len(lab)), lab]) * wr).sum()
            res = np.exp(m - lse[:, None])
            res[np.arange(len(lab)), lab] -= 1.0
            res *= wr[:, None]
        return part, (res.T @ x if with_grad else None), res.sum(0)

    for part, gc, gb in _chunk_map(chunk, X):
        loss += part
        if with_grad:
            g_coef += gc
            g_b += gb
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


def trace_device_us(prof) -> float:
    """The device time of a finished torch.profiler trace: the sum of its
    device-side activities' durations (kernels, copies, fills), the same
    sum as `self_device_time_total` over `key_averages()`' CUDA entries
    (a CPU op's entry counts its kernels' time too, so only the device's
    own entries count), read from the raw trace: `key_averages()` builds
    every event's tree first, which takes tens of seconds on a trace of a
    fit's tens of thousands of launches."""
    from torch.autograd import DeviceType

    # the names key_averages() leaves out (torch.autograd.profiler._filter_name)
    skip = {"[memory]", "[OutOfMemory]", "profiler::_record_function_enter",
            "profiler::_record_function_enter_new", "profiler::_record_function_exit",
            "aten::is_leaf", "aten::output_nr", "aten::_version"}
    total_ns = 0
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() != DeviceType.CUDA or e.is_async()
                or e.start_thread_id() != e.end_thread_id() or e.name() in skip
                or getattr(e, "is_hidden_event", lambda: False)()):
            continue
        total_ns += e.end_ns() - e.start_ns()
    return total_ns / 1e3


def hold_trace_read(launches: int = 1000) -> None:
    """`trace_device_us` against `key_averages()`' sum on one trace of
    2 x `launches` small kernels: equal to 1e-9 relative (the script's
    busy shares read the first), with each read's seconds."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(4096, 256, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(launches):
            (x * 2.0).sum(0)
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    raw = trace_device_us(prof)
    t1 = time.perf_counter()
    agg = sum(e.self_device_time_total for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA)
    t2 = time.perf_counter()
    log(f"  profiler device time of {2 * launches} launches: raw events {raw:.3f} us in "
        f"{t1 - t0:.3f} s, key_averages() {agg:.3f} us in {t2 - t1:.3f} s")
    if not raw > 0 or abs(raw - agg) > 1e-9 * agg:
        raise AssertionError("trace_device_us differs from the key_averages() sum")


def device_busy_share(fn) -> tuple:
    """(wall ms of one `fn()` call, the share of it the card spent in
    kernels) from a torch.profiler trace of the call (`trace_device_us`);
    the share is None when the trace holds no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_us = trace_device_us(prof)
    return wall_ms, (busy_us / 1e3 / wall_ms if busy_us > 0 else None)


def phase_logistic_cell(device, name: str, X, y, w, classes: int, fit_kw: dict,
                        transform_rows: int, seed: int, weight_col: bool) -> dict:
    """One LogisticRegression cell through the public entry points: fits
    from a DeviceDataset (cold, then one warm) and from host
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
    warm = [fit(ds)]
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


def start_logistic_rows(args) -> tuple:
    """Phase 5's (a) and (b) rows, made by bench.py's generator on one host
    thread (numpy's generator runs without the interpreter lock) while
    phases 1-5 run: futures of ((X, y), seconds)."""
    import concurrent.futures

    def timed(n: int, d: int):
        t0 = time.perf_counter()
        out = gen_binary(n, d, seed=0)
        return out, time.perf_counter() - t0

    ex = concurrent.futures.ThreadPoolExecutor(1, thread_name_prefix="phase5-rows")
    futures = (ex.submit(timed, args.lr_rows, args.lr_dim),
               ex.submit(timed, args.lr_wide_rows, args.lr_wide_dim))
    ex.shutdown(wait=False)
    return futures


def _made_rows(future, name: str):
    """The rows of a `start_logistic_rows` future, with how they were made."""
    t0 = time.perf_counter()
    (X, y), gen_s = future.result()
    log(f"  {name} data {X.shape} float32 from bench.py's _gen_binary(seed=0): {gen_s:.2f} s "
        f"on a host thread beside the phases before, {time.perf_counter() - t0:.2f} s waited")
    return X, y


def phase_logistic(device, args, rows) -> dict:
    """(a) bench.py's headline, (b) the reference benchmark's width, (c)
    softmax + OWL-QN + weights in float64, also fitted on the CPU.  `rows`
    are `start_logistic_rows`' futures."""
    from spark_rapids_ml_torch import set_default_device
    from spark_rapids_ml_torch.classification import LogisticRegression

    cells = []
    bench_kw = dict(regParam=1e-4, elasticNetParam=0.0, tol=1e-8)
    X, y = _made_rows(rows[0], "(a)")
    sl = np.random.default_rng(args.seed + 11).choice(len(y), size=min(65536, len(y)),
                                                     replace=False)
    check_oracle("(a) 65,536-row slice", X[sl], y[sl], np.ones(len(sl), np.float32), 2, 1e-4,
                 1e-5, device, args.seed)
    cells.append(phase_logistic_cell(device, f"(a) {args.lr_rows}x{args.lr_dim} float32 binomial",
                                     X, y, None, 2, dict(bench_kw, maxIter=50), 1_000_000,
                                     args.seed, weight_col=False))
    model_a, X_a = cells[-1]["model"], X
    del X, y

    X, y = _made_rows(rows[1], "(b)")
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


def _timed_fit(make, data, device, profiled: bool = False):
    """(seconds, model, GB) of one `make().fit(data)`, the card idle before
    and after; GB is max_memory_allocated during the fit less what was
    allocated before it (a DeviceDataset's rows, for one): the memory the
    route itself takes.  `profiled` runs the fit under `device_busy_share`
    and appends the card's busy share to the tuple."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    out = {}

    def fit():
        out["model"] = make().fit(data)

    if profiled:
        wall_ms, busy = device_busy_share(fit)
        seconds = wall_ms / 1e3
    else:
        t0 = time.perf_counter()
        fit()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    gb = (torch.cuda.max_memory_allocated(device) - base) / 1e9
    return (seconds, out["model"], gb) + ((busy,) if profiled else ())


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

    # one fit, timed under torch.profiler (its trace adds nothing measurable
    # to a KMeans fit's few launches an iteration: 3.528 s plain against
    # 3.483 s profiled at (h) on an H100)
    rec["fit_s"], model, gb, rec["device_busy_share"] = _timed_fit(make, ds, device,
                                                                   profiled=True)
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
    log(f"  {name}: the fit under torch.profiler: the card busy in kernels "
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
        # the transform above ran the pass's code already: one pass timed,
        # and one under torch.profiler
        r["pass_ms"] = cuda_ms(one_pass, reps=1, warm=False)
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
            f"{r['device_busy_share_one_pass'] or 0:.1%} (one pass)")
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


# The phase's trees, cut to what the script's time allows (its limit is
# 1,200 s; phases 14-16 take about three minutes of it): (n)
# BASELINE.json configs[3]'s rows, 1 of its 100 trees (about 3.4 s a tree
# on an H100),
# its fit from numpy 1; (l) 2 of the reference benchmark's 50 trees
# (1.6 s a tree), (m) 2 of its 30 (0.9 s a tree), their fits from numpy 1
# (the same first tree)
RF_N_ROWS, RF_N_TREES = 100_000_000, 1
RF_O_ROWS = 100_000  # (o)'s rows, fitted on the card and on the CPU
RF_L_TREES, RF_M_TREES, RF_NUMPY_TREES = 2, 2, 1


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
    # from numpy RF_NUMPY_TREES (the same first trees): a tree costs the same
    # as in the 50-tree fit, and the other trees would add a minute to the
    # script
    cells.append(phase_forest_cell(device, f"(l) random_forest_classifier_50t_d13 {n}x{d}, "
                                   f"{RF_L_TREES} of its 50 trees", Xl,
                                   yl, rfc, wide_X, wide_y, 2, False, 2, args.seed + 71,
                                   1_000_000, numpy_trees=RF_NUMPY_TREES))
    clf_model = cells[-1].pop("model")

    # (m): a label made from the seed, a nonlinear function of a few columns
    # plus noise, computed on the card
    gen = torch.Generator(device=device).manual_seed(args.seed + 72)
    ym = (2.0 * Xl[:, 0] + torch.sin(3.0 * Xl[:, 1]) + Xl[:, 2] * Xl[:, 3]
          + 0.5 * torch.randn(n, generator=gen, device=device))
    ym_host = ym.cpu().numpy()

    def rfr(**kw):
        return RandomForestRegressor(**{**dict(numTrees=RF_M_TREES, maxDepth=6,
                                               maxBins=128, seed=0), **kw})

    cells.append(phase_forest_cell(device, f"(m) random_forest_regressor_30t_d6 {n}x{d}, "
                                   f"{RF_M_TREES} of its 30 trees", Xl, ym,
                                   rfr, wide_X, ym_host, 0, False, 2, args.seed + 73,
                                   1_000_000, numpy_trees=RF_NUMPY_TREES))
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
                                   Xn_host, yn_host, 2, False, 1, args.seed + 74, 1_000_000,
                                   numpy_trees=1))
    cells[-1].pop("model")
    del Xn, yn, Xn_host, yn_host
    torch.cuda.empty_cache()

    cells.extend(phase_forest_float64(device, RF_O_ROWS, args.seed + 75)["cells"])

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


# (p)'s file holds phase 5's (b) rows with its first columns scaled by these
# (phase 10's spectral gap)
PARQUET_SCALE = np.array([16.0, 8.0, 4.0], np.float32)
# (p)'s file: the first PARQUET_ROWS of phase 5's (b) rows at its full width
PARQUET_ROWS = 500_000


def start_reference_parquet(path: str, X, y):
    """Write (p)'s file (`write_reference_parquet` of X with its first
    columns times `PARQUET_SCALE`, slab by slab, X left as it is) on a host
    thread: a future of the seconds it took."""
    import concurrent.futures

    def write() -> float:
        t0 = time.perf_counter()
        write_reference_parquet(path, X, y, scale=PARQUET_SCALE)
        return time.perf_counter() - t0

    ex = concurrent.futures.ThreadPoolExecutor(1, thread_name_prefix="parquet-writer")
    future = ex.submit(write)
    ex.shutdown(wait=False)
    return future


def write_reference_parquet(path: str, X, y, slab: int = 50_000, scale=None) -> None:
    """bench.py:900-931's layout: FixedSizeList float32 `features`, float64
    `label`, written in `slab`-row row groups (default compression).
    `scale` multiplies a copy of each slab's first columns."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    n, d = X.shape
    writer = None
    try:
        for at in range(0, n, slab):
            rows = np.array(X[at:at + slab], copy=True)
            if scale is not None:
                rows[:, :len(scale)] *= scale
            t = pa.table({
                "features": pa.FixedSizeListArray.from_arrays(pa.array(rows.reshape(-1)), d),
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


def phase_parquet_reference(device, tmp: str, X, y, path: str, written) -> list:
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
    # (q) meets the randomized one of (p); undone (exactly) at the end.  The
    # file, written beside phases 8 and 9, holds the scaled rows too
    X[:, :3] *= PARQUET_SCALE
    try:
        return _parquet_reference_cells(device, tmp, X, y, path, written)
    finally:
        X[:, :3] /= PARQUET_SCALE


def _parquet_reference_cells(device, tmp: str, X, y, path: str, written) -> list:
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
    t_write = written.result()
    size = os.path.getsize(path)
    log(f"  (p) wrote {n} x {d} float32 rows + labels as parquet (50,000-row row groups): "
        f"{size / 1e9:.2f} GB in {t_write:.2f} s on a host thread beside phases 8 and 9, "
        f"{time.perf_counter() - t0:.2f} s waited")
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
    # a budget of 0.8 x half the rows' bytes (at 500k x 3000: 2.4 GB, below 6 GB)
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

def phase_parquet(device, args, wide_X, wide_y, tmp: str, written) -> dict:
    """Phase 10: (p) and (q) on phase 5's 1M x 3000 rows written as parquet
    (`written`: `start_reference_parquet`'s future), (r) bench.py's 2M x 64
    streaming cell, in `tmp`; both files stay for phase 11."""
    import shutil

    du = shutil.disk_usage(tmp)
    log(f"  temporary directory {tmp}: {du.free / 1e9:.1f} GB free of {du.total / 1e9:.1f} GB")
    paths = {"p": os.path.join(tmp, "ref_1m_3k.parquet"), "r": os.path.join(tmp, "stream.parquet")}
    cells = phase_parquet_reference(device, tmp, wide_X, wide_y, paths["p"], written)
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
    (p)'s 6 GB file twice: the first call decodes and fills the cache, the
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


# ---------------------------------------------------------------------------
# phase 13: ApproximateNearestNeighbors
# ---------------------------------------------------------------------------

# (x) BASELINE.json configs[4], (y) CAGRA's cell and bench.py's bench_ann
# cell (bench.py:255-303), (z) the checks on (y)'s 200k x 64 data
ANN_X_ROWS, ANN_Y_ROWS, ANN_Z_ROWS = 10_000_000, 1_000_000, 200_000
ANN_QUERIES, ANN_K = 10_000, 10
# tests/test_ann.py's recall floors, by algorithm
ANN_FLOORS = {"ivfflat": 0.85, "ivfpq": 0.7, "cagra": 0.95}


def card_blobs(n: int, d: int, centres: int, seed: int, device):
    """`make_blobs` made on the card: centres uniform in (-10, 10)^d, n //
    centres rows each (the first n % centres one more), unit gaussian
    spread, rows in random order; float32."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    C = torch.rand((centres, d), generator=gen, device=device) * 20.0 - 10.0
    label = torch.randperm(n, generator=gen, device=device) % centres
    X = torch.randn((n, d), generator=gen, device=device)
    return X.add_(C[label])


def ann_recall(got: np.ndarray, truth: np.ndarray) -> float:
    """recall@k: the share of the exact k nearest that the search found."""
    hits = (got[:, :, None] == truth[:, None, :]).any(axis=2).sum()
    return float(hits / truth.size)


def _synced(device):
    import torch

    torch.cuda.synchronize(device)
    return time.perf_counter()


def exact_neighbours(device, X, Q, k: int):
    """The port's exact NearestNeighbors (the fused kernel): (ids, seconds
    of the kneighbors call, the model)."""
    from spark_rapids_ml_torch.knn import NearestNeighbors

    model = NearestNeighbors(k=k).fit(X)
    t0 = _synced(device)
    _, _, df = model.kneighbors(Q)
    return np.stack(df["indices"]), time.perf_counter() - t0, model


def ann_search_split(device, model, Q, k: int) -> dict:
    """The warm search's parts: `_search` with a LayerTimer (probe and
    fold, or the beam's entry and steps, and the host re-rank; ms between
    CUDA events, so the re-rank's is its host time)."""
    import torch

    timer = LayerTimer()
    model._search(np.ascontiguousarray(Q, np.float32), k, timer=timer)
    torch.cuda.synchronize(device)
    totals = timer.totals()
    return {"ms": {name: round(v["ms"], 3) for name, v in totals.items()},
            "span_calls": {name: v["calls"] for name, v in totals.items()}}


def ann_cell(device, name: str, X, Q, truth, algo: str, params: dict, floor=None,
             metric: str = "euclidean", round_split: bool = False) -> dict:
    """One ANN cell through the public entry points: fit (the build, its
    parts), the index's upload, a first and a warm kneighbors (queries/s),
    the warm search's parts, recall@k against `truth`; `floor`, where
    given, is held.  With `round_split`, one more NN-descent round from the
    built graph runs under a LayerTimer (its parts, device ms)."""
    import torch

    from spark_rapids_ml_torch.knn import ApproximateNearestNeighbors
    from spark_rapids_ml_torch.models.knn import _INDEX_ARRAYS
    from spark_rapids_ml_torch.ops import cagra as cagra_ops
    from spark_rapids_ml_torch.ops import ivf as ivf_ops

    from spark_rapids_ml_torch.ops import kmeans as kmeans_ops

    k = truth.shape[1]
    t0 = _synced(device)
    model = ApproximateNearestNeighbors(k=k, algorithm=algo, algoParams=params,
                                        metric=metric).fit(X)
    build_s = _synced(device) - t0
    parts = ({"rounds_s": list(cagra_ops.LAST_BUILD["rounds"])} if algo == "cagra"
             else dict(ivf_ops.LAST_BUILD))
    lloyd_passes = int(kmeans_ops.LAST_FIT.get("n_iter", 0)) + 1  # the final cost pass
    t0 = _synced(device)
    model._staged_index(_INDEX_ARRAYS[algo], device)
    upload_s = _synced(device) - t0
    t0 = _synced(device)
    model.kneighbors(Q)
    first_s = _synced(device) - t0
    t0 = _synced(device)
    _, _, df = model.kneighbors(Q)
    warm_s = _synced(device) - t0
    got = np.stack(df["indices"])
    dist = np.stack(df["distances"])
    rec = ann_recall(got, truth)
    split = ann_search_split(device, model, Q, k)
    index_bytes = sum(np.asarray(model._attrs[nm]).nbytes for nm in _INDEX_ARRAYS[algo])
    cell = {"cell": name, "algorithm": algo, "params": params, "metric": metric,
            "items": list(X.shape), "queries": int(Q.shape[0]), "k": k, "build_s": build_s,
            "build_parts_s": parts, "upload_s": upload_s,
            "upload_gb_per_s": index_bytes / upload_s / 1e9, "first_kneighbors_s": first_s,
            "warm_kneighbors_s": warm_s, "queries_per_s": Q.shape[0] / warm_s,
            "search_parts": split, f"recall_at_{k}": rec, "floor": floor,
            "bounds_ms": ann_bounds(device, model, X, Q, k, split, lloyd_passes)}
    if algo != "cagra":
        cell["index_shape"] = {"nsub_cap": list(model._attrs["ivf_bucket_ids"].shape),
                               "max_sub": int(model._attrs["ivf_sub_table"].shape[1])}
    if round_split:
        items, graph = model._staged_index(_INDEX_ARRAYS["cagra"], device)
        n, deg = graph.shape
        sample = int(params.get("nn_descent_sample", deg))
        gen = cagra_ops._generator(1, device)
        timer = LayerTimer()
        t0 = _synced(device)
        cagra_ops._nn_descent_round(items, kmeans_ops.row_norms(items), graph.long(),
                                    cagra_ops._own_round(gen, n, deg, sample, device), deg,
                                    sample, timer=timer)
        cell["one_round_s"] = _synced(device) - t0
        cell["one_round_device_ms"] = {nm: round(v["ms"], 3)
                                       for nm, v in timer.totals().items()}
        C = 2 * deg + min(sample, 2 * deg) * deg + deg
        d = X.shape[1]
        # the round's function: n C products of d, X read once; the gather
        # form moves each row's C candidate rows twice (written, read)
        cell["one_round_bound_ms"] = max(2.0 * n * C * d / _PEAK_FP32,
                                         4.0 * n * (d + 3 * deg) / _PEAK_BYTES_PER_S) * 1e3
        cell["one_round_gather_bound_ms"] = 2.0 * n * C * d * 4 / _PEAK_BYTES_PER_S * 1e3
    log(f"  {name}: build {build_s:.3f} s {json.dumps(parts, default=float)}, upload "
        f"{upload_s:.3f} s; kneighbors first {first_s:.3f} s, warm {warm_s:.3f} s "
        f"({Q.shape[0] / warm_s:.1f} queries/s); parts {json.dumps(split)}; recall@{k} "
        f"{rec:.4f}" + (f" (floor {floor})" if floor is not None else " (no floor)"))
    if round_split:
        log(f"    one more NN-descent round {cell['one_round_s']:.3f} s, device ms "
            f"{cell['one_round_device_ms']}, bound {cell['one_round_bound_ms']:.3f} ms "
            f"(FP32 products), the gather form's bytes {cell['one_round_gather_bound_ms']:.3f} ms")
    if got.shape != (Q.shape[0], k) or not np.isfinite(dist).all() or (got < 0).any():
        raise AssertionError(f"{name}: kneighbors gave {got.shape}, an unreachable slot or a "
                             "non-finite distance")
    if floor is not None and not rec >= floor:
        raise AssertionError(f"{name}: recall@{k} {rec:.4f} below the floor {floor}")
    del model
    torch.cuda.empty_cache()
    return cell


def ann_bounds(device, model, X, Q, k: int, split: dict, lloyd_passes: int) -> dict:
    """Least device ms of each layer this run needed, from its shapes and
    this run's probe: IEEE float32 products at the FP32 peak, bytes (each
    input read once) at the HBM rate, the larger of the two."""
    import torch

    from spark_rapids_ml_torch.ops import ivf as ivf_ops
    from spark_rapids_ml_torch.parallel import RowStager

    n, d = X.shape
    q = Q.shape[0]

    def b(flops, nbytes):
        return max(flops / _PEAK_FP32, nbytes / _PEAK_BYTES_PER_S) * 1e3

    ap = dict(model._tpu_params.get("algo_params") or {})
    if model.algorithm_ == "cagra":
        deg = model._attrs["cagra_graph"].shape[1]
        beam = max(int(ap.get("itopk_size", 64)), k)
        steps = split["span_calls"].get("step", 0)
        per_q = beam * deg + deg  # candidates scored a step
        return {"entry": b(2.0 * q * 4 * beam * d, 4.0 * (n * d + q * d)),
                "steps": b(2.0 * steps * q * per_q * d, 4.0 * (n * d + n * deg + q * d))}
    nlist = model.nlist_
    nprobe = max(1, min(int(ap.get("nprobe", 20)), nlist))
    n_train = min(n, max(nlist * 256, 16384))
    centers, sub_table = model._staged_index(("ivf_centers", "ivf_sub_table"), device)
    valid = torch.as_tensor(model._attrs["ivf_bucket_valid"], device=device).sum(dim=1)
    per_parent = torch.where(sub_table >= 0, valid[sub_table.clamp(min=0)], 0).sum(dim=1)
    Qs = RowStager(q, device).stage(Q, np.float32)
    _, probe, _ = ivf_ops._probe(Qs, centers, sub_table, nprobe)
    cand = float(per_parent[probe].sum())  # the rows this run's probes scanned
    out = {"assign": b(2.0 * n * nlist * d, 4.0 * n * d),
           "probe": b(2.0 * q * nlist * d, 4.0 * (nlist * d + q * d)),
           "candidates_scanned": cand}
    if model.algorithm_ == "ivfflat":
        out["quantizer"] = b(2.0 * lloyd_passes * n_train * nlist * d, 4.0 * n_train * d)
        out["fold"] = b(2.0 * cand * d, 4.0 * (n * d + q * d))
    else:
        M = int(model._attrs.get("pq_M", 8))
        ksub = model._attrs["pq_codebooks"].shape[1]
        # the tables: q nprobe (M ksub) products of d / M; the fold: M table
        # adds a candidate, the codes read once
        out["tables"] = b(2.0 * q * nprobe * ksub * d, 4.0 * q * nprobe * M * ksub)
        out["fold"] = b(float(M) * cand, float(n * M))
    return out


def same_ids_ties_aside(name: str, got, want, X, Q) -> float:
    """Ids equal slot for slot, except where both ids sit at float64 squared
    distances within 1e-5 of ||q||^2 + max ||x||^2 (the matmul identity's
    float32 rounding, which may swap near ties); the share equal."""
    diff = np.argwhere(got != want)
    X64, Q64 = X.astype(np.float64), Q.astype(np.float64)
    scale = (Q64 * Q64).sum(1) + (X64 * X64).sum(1).max()
    for i, j in diff:
        dg = ((Q64[i] - X64[got[i, j]]) ** 2).sum()
        dw = ((Q64[i] - X64[want[i, j]]) ** 2).sum()
        if abs(dg - dw) > 1e-5 * scale[i]:
            raise AssertionError(f"{name}: query {i} slot {j}: id {got[i, j]} at {dg} against "
                                 f"{want[i, j]} at {dw}: not a tie")
    share = 1.0 - len(diff) / got.size
    log(f"  {name}: ids equal on {share:.6f} of slots, every other slot a tie")
    return share


def hold_at_blob_norms(name: str, kd, kp, td, tp, X, Q) -> float:
    """The kernel's (d2, positions) against its twin's where rows have
    large norms and small distances (blobs centred up to 10 from the
    origin, queries among the items): both forms cancel ||q||^2 + ||x||^2
    (about 4,400 at 128 dims) to reach a d2 near 0, so d2 is held within
    1e-5 of that sum, not of d2 (phase 3's rule, on unit-scale rows), and
    ids slot for slot, ties aside."""
    kd, td = kd.cpu().double().numpy(), td.cpu().double().numpy()
    kp, tp = kp.cpu().numpy(), tp.cpu().numpy()
    if not (np.array_equal(np.isfinite(kd), np.isfinite(td)) and np.isfinite(td).all()):
        raise AssertionError(f"{name}: non-finite or differing tails")
    scale = (Q.astype(np.float64) ** 2).sum(1)[:, None] + float(
        (X[:: max(1, X.shape[0] // 1_000_000)].astype(np.float64) ** 2).sum(1).max())
    err = float(np.abs(kd - td).max())
    worst = float((np.abs(kd - td) / scale).max())
    log(f"  {name}: max|d2 kernel - d2 twin| = {err:.3e}, {worst:.2e} of ||q||^2 + max ||x||^2 "
        "(limit 1e-5)")
    if worst > 1e-5:
        raise AssertionError(f"{name}: d2 differs by {worst:.2e} of the norms")
    same_ids_ties_aside(name, kp, tp, X, Q)
    return err


def fused_10m_entry(device, nn_model, Q, k: int, launches: dict, X) -> dict:
    """The float32 fused function at (x)'s shape, as phase 13 launches it:
    timed, held against its plain version on 1,000 of the queries (the
    plain version's 10M x 10k takes about 12 s), beside its bound and the
    library's blocked matmul + topk."""
    import torch

    from spark_rapids_ml_torch.ops import fused_knn as fk

    items_t, valid_t, _ = nn_model._device_items[1]
    n, d = items_t.shape
    q = Q.shape[0]
    queries_t = torch.as_tensor(Q, device=device)
    ms = cuda_ms(lambda: fk.fused_topk_sqdist(items_t, valid_t, queries_t, k), reps=2)
    q1 = queries_t[:1000]
    kd, kp = fk.fused_topk_sqdist(items_t, valid_t, q1, k)
    plain = {}

    def run_plain():
        plain["out"] = fk.fused_topk_sqdist_reference(items_t, valid_t, q1, k, bq=1024, bn=8192)

    plain_ms = cuda_ms(run_plain, reps=1, warm=False)
    err = hold_at_blob_norms("fused function at (x), 1,000 queries: kernel vs twin", kd, kp,
                             *plain["out"], X, Q[:1000])
    library_ms = cuda_ms(lambda: library_topk(items_t, queries_t, k, block=256), reps=1,
                         warm=False)
    flops = 2.0 * q * n * d
    nbytes = 4.0 * (n * d + q * d + 2 * n) + 8.0 * q * k
    bound_ms, bound_by = bound(3 * flops, _PEAK_TF32, nbytes)
    log(f"  fused_topk_sqdist at {n} x {d}, {q} queries, k={k}: {ms:.3f} ms "
        f"({q / ms * 1e3:.1f} queries/s), bound {bound_ms:.3f} ms ({bound_by}, share "
        f"{bound_ms / ms:.1%}); twin {plain_ms:.3f} ms on 1,000 queries; library matmul+topk "
        f"{library_ms:.3f} ms (256-query blocks); launches {launches}")
    return entry("fused_knn_tf32", launches["main"], err, ms, plain_ms, bound_ms, bound_by,
                 library_ms, f"{n}x{d} float32 items, {q} queries, k={k} (phase 13 (x)); "
                 "plain_ms and max_abs_err on 1,000 of the queries; library_ms in 256-query "
                 "blocks")


def phase_ann_x(device, seed: int) -> tuple:
    """(x) BASELINE.json configs[4]: 10M x 128 blobs, 100 centres, made on
    the card; queries the first 10k rows, k = 10; the exact ground truth on
    the fused kernel, then IVF-Flat (nlist sqrt(n), nprobe 20) and IVF-PQ
    (M 8, n_bits 8, refine 2)."""
    import torch

    from spark_rapids_ml_torch.ops import fused_knn as fk

    t0 = _synced(device)
    Xd = card_blobs(ANN_X_ROWS, 128, 100, seed, device)
    X = Xd.cpu().numpy()
    del Xd
    torch.cuda.empty_cache()
    Q = X[:ANN_QUERIES]
    log(f"  (x) data: {X.shape} float32 blobs, 100 centres, made on the card and copied to the "
        f"host: {time.perf_counter() - t0:.2f} s")
    reset_counts()
    truth, gt_s, nn_model = exact_neighbours(device, X, Q, ANN_K)
    launches = {"main": fk.LAUNCHES, "split": fk.SPLIT_LAUNCHES, "merge": fk.MERGE_LAUNCHES}
    if min(launches.values()) < 1:
        raise AssertionError(f"(x) ground truth did not run the fused kernels: {launches}")
    log(f"  (x) exact ground truth (NearestNeighbors, the fused kernel; items staged): "
        f"{gt_s:.3f} s, {ANN_QUERIES / gt_s:.1f} queries/s; launches {launches}")
    kernel = fused_10m_entry(device, nn_model, Q, ANN_K, launches, X)
    del nn_model
    torch.cuda.empty_cache()
    cells = [{"cell": "(x) exact ground truth", "items": list(X.shape), "queries": ANN_QUERIES,
              "k": ANN_K, "kneighbors_s": gt_s, "queries_per_s": ANN_QUERIES / gt_s}]
    nprobe = 20
    cells.append(ann_cell(device, "(x) IVF-Flat", X, Q, truth, "ivfflat", {"nprobe": nprobe},
                          floor=ANN_FLOORS["ivfflat"]))
    cells.append(ann_cell(device, "(x) IVF-PQ", X, Q, truth, "ivfpq", {"nprobe": nprobe}))
    return cells, kernel, X


def phase_ann_y(device, X10m, seed: int) -> tuple:
    """(y) CAGRA (graph_degree 32) at 1M x 128 (the first 1M of (x)'s
    rows), then bench.py's bench_ann cell: 200k x 64 blobs, 100 centres,
    CAGRA and IVF-Flat (nlist 448, nprobe 20), and IVF-PQ in
    tests/test_ann.py's regime (4 dims a subspace, refine 4)."""
    X1 = np.ascontiguousarray(X10m[:ANN_Y_ROWS])
    Q1 = X1[:ANN_QUERIES]
    truth1, gt1_s, m1 = exact_neighbours(device, X1, Q1, ANN_K)
    del m1
    log(f"  (y) exact ground truth at {X1.shape}: {gt1_s:.3f} s")
    cells = [ann_cell(device, "(y) CAGRA 1M x 128", X1, Q1, truth1, "cagra",
                      {"graph_degree": 32}, round_split=True)]
    X2, _ = make_blobs(ANN_Z_ROWS, 64, 100, 1.0, seed + 4)
    X2 = X2.astype(np.float32)
    Q2 = X2[:ANN_QUERIES]
    truth2, gt2_s, nn2 = exact_neighbours(device, X2, Q2, ANN_K)
    log(f"  (y) exact ground truth at {X2.shape}: {gt2_s:.3f} s")
    cells.append(ann_cell(device, "(y) CAGRA 200k x 64", X2, Q2, truth2, "cagra",
                          {"graph_degree": 32}, floor=ANN_FLOORS["cagra"], round_split=True))
    cells.append(ann_cell(device, "(y) IVF-Flat 200k x 64", X2, Q2, truth2, "ivfflat",
                          {"nlist": 448, "nprobe": 20}, floor=ANN_FLOORS["ivfflat"]))
    cells.append(ann_cell(device, "(y) IVF-PQ 200k x 64, 16 subspaces, refine 4", X2, Q2,
                          truth2, "ivfpq", {"nlist": 448, "nprobe": 20, "M": 16,
                                            "refine_ratio": 4}, floor=ANN_FLOORS["ivfpq"]))
    return cells, (X2, Q2, truth2, nn2)


def phase_ann_z(device, X2, Q2, truth2, nn2) -> list:
    """(z) on (y)'s 200k x 64 data: IVF-Flat with every list probed against
    the fused kernel's ids; cosine on IVF-Flat and CAGRA; save, load and
    kneighbors equal; `umap_knn_graph` for euclidean (the fused kernel)
    and manhattan against their plain forms."""
    import torch

    from spark_rapids_ml_torch.knn import (
        ApproximateNearestNeighbors,
        ApproximateNearestNeighborsModel,
    )
    from spark_rapids_ml_torch.ops.distances import finalize_sqdist, umap_knn_graph
    from spark_rapids_ml_torch.ops.knn import knn_topk_blocked, knn_topk_single, smallest_k

    k = ANN_K
    out = {"cell": "(z) checks at 200k x 64"}
    # full probe: the fold over every sub-list is exact
    model = ApproximateNearestNeighbors(k=k, algoParams={"nlist": 448, "nprobe": 448}).fit(X2)
    t0 = _synced(device)
    _, _, df = model.kneighbors(Q2)
    out["full_probe_s"] = _synced(device) - t0
    out["full_probe_ids_equal_share"] = same_ids_ties_aside(
        "(z) IVF-Flat full probe against the fused kernel", np.stack(df["indices"]), truth2,
        X2, Q2)
    # save, load, kneighbors equal
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ann")
        model.save(path)
        loaded = ApproximateNearestNeighborsModel.load(path)
        _, _, df2 = loaded.kneighbors(Q2)
    if not (np.array_equal(np.stack(df["indices"]), np.stack(df2["indices"]))
            and np.array_equal(np.stack(df["distances"]), np.stack(df2["distances"]))):
        raise AssertionError("(z) a loaded model's kneighbors differs from the saved one's")
    log("  (z) save, load, kneighbors: equal ids and distances")
    del model, loaded
    # cosine: the exact truth is euclidean on unit rows
    U = X2 / np.maximum(np.linalg.norm(X2, axis=1, keepdims=True), 1e-12).astype(np.float32)
    ctruth, _, m = exact_neighbours(device, U, U[:ANN_QUERIES], k)
    del m
    for algo, params, floor in (("ivfflat", {"nlist": 448, "nprobe": 20}, ANN_FLOORS["ivfflat"]),
                                ("cagra", {"graph_degree": 32}, 0.9)):
        cm = ApproximateNearestNeighbors(k=k, algorithm=algo, algoParams=params,
                                         metric="cosine").fit(X2)
        _, _, cdf = cm.kneighbors(Q2)
        ids, dist = np.stack(cdf["indices"]), np.stack(cdf["distances"])
        rec = ann_recall(ids, ctruth)
        cos = 1.0 - (U[:ANN_QUERIES, None, :].astype(np.float64)
                     * U[ids].astype(np.float64)).sum(-1)
        err = float(np.abs(dist - cos).max())
        out[f"cosine_{algo}"] = {"recall_at_10": rec, "max_abs_distance_err": err}
        log(f"  (z) cosine {algo} {params}: recall@10 {rec:.4f} (floor {floor}), "
            f"|1 - cos error| {err:.2e} (limit 2e-3)")
        if rec < floor or err > 2e-3:
            raise AssertionError(f"(z) cosine {algo}: recall {rec:.4f} or distance error {err}")
        del cm
    # umap_knn_graph: euclidean rides the fused kernel, manhattan the tiled form
    items_t, valid_t, ids_t = nn2._device_items[1]
    Qt = torch.as_tensor(Q2, device=device)
    dist, ids = umap_knn_graph(items_t, valid_t, ids_t, Qt, k, "euclidean")
    umap_d2, _ = knn_topk_single(items_t, valid_t, ids_t, Qt, k)
    pd2, pids = knn_topk_blocked(items_t, valid_t, ids_t, Qt, k)
    out["umap_euclidean_err"] = hold_at_blob_norms(
        "(z) umap_knn_graph euclidean against the plain blocked form", umap_d2, ids, pd2,
        pids, X2, Q2)
    # the final distances are the root of the squared ones, nothing else
    if not torch.equal(dist, finalize_sqdist(umap_d2, "euclidean")):
        raise AssertionError("(z) umap_knn_graph euclidean: distances are not sqrt(d2)")
    q_man = Qt[:1000]
    md, mi = umap_knn_graph(items_t, valid_t, ids_t, q_man, k, "manhattan")
    man_ms = cuda_ms(lambda: umap_knn_graph(items_t, valid_t, ids_t, q_man, k, "manhattan"),
                     reps=1)

    def plain_manhattan():
        return smallest_k(torch.cdist(q_man, items_t, p=1.0), k)

    pmd, ppos = plain_manhattan()
    plain_ms = cuda_ms(plain_manhattan, reps=1)
    out["umap_manhattan_err"] = compare("(z) umap_knn_graph manhattan against cdist(p=1) + "
                                        "top-k", md, mi, pmd, ids_t[ppos], exact=False)
    out["umap_manhattan_ms"] = {"tiled": man_ms, "cdist_plain": plain_ms, "queries": 1000}
    log(f"  (z) manhattan, 1,000 queries over {X2.shape}: tiled {man_ms:.3f} ms, cdist + "
        f"top-k {plain_ms:.3f} ms")
    return [out]


def phase_ann(device, args) -> dict:
    """Phase 13: ApproximateNearestNeighbors, (x), (y) and (z)."""
    import torch

    from spark_rapids_ml_torch import config
    from spark_rapids_ml_torch.parallel import device_cache

    config.reset_config()
    device_cache.clear_device_cache()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    cells, kernel, X = phase_ann_x(device, args.seed)
    log(f"  (x) done at {time.perf_counter() - t_phase:.1f} s")
    ycells, z_data = phase_ann_y(device, X, args.seed)
    log(f"  (y) done at {time.perf_counter() - t_phase:.1f} s")
    cells += ycells + phase_ann_z(device, *z_data)
    log(f"  phase 13 {time.perf_counter() - t_phase:.1f} s")
    torch.cuda.empty_cache()
    # (x)'s host rows stay for phase 14
    return {"cells": cells, "kernel": kernel, "X": X}


# ---------------------------------------------------------------------------
# phase 14: UMAP
# ---------------------------------------------------------------------------

# (aa) BASELINE.json configs[4] (UMAP / approx k-NN on 10M x 128) fits on a
# tenth of (x)'s rows, as the reference fits UMAP on one worker's sample;
# (bb) bench.py's bench_umap cells (bench.py:814-860); (cc) the fused kernel
# on UMAP's path: a brute-force fit, and a transform at k > 32; (dd) checks
UMAP_AA_FRACTION = 0.1
UMAP_QUERIES = 10_000
UMAP_TRUST_ROWS = 5_000
UMAP_BB = ((100_000, 100, 5), (1_000_000, 50, 7))  # rows, epochs, numpy seed
UMAP_CC_ROWS, UMAP_CC_K = 50_000, 40
# (dd)'s float64 epochs, card against CPU: few, since the SGD grows a
# last-place difference about tenfold an epoch
UMAP_DD_EPOCHS = 6
# trustworthiness (k = 15, 5,000 of the fit's rows) held at (aa), from CPU
# runs of the port and the JAX package on card_blobs at a cut size
# (PERF.md section 6)
UMAP_TRUST_FLOOR = 0.99


def trustworthiness(X, emb, k: int, device) -> float:
    """scikit-learn's trustworthiness (the card has no scikit-learn): 1 -
    2 / (n k (2n - 3k - 1)) times the sum, over each row's k nearest in the
    embedding, of how far past k each ranks among the row's nearest in the
    input space; float64 distances on `device`, self excluded."""
    import torch

    Xt = torch.as_tensor(np.asarray(X, np.float64), device=device)
    Et = torch.as_tensor(np.asarray(emb, np.float64), device=device)
    n = Xt.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=device)
    order = torch.argsort(torch.cdist(Xt, Xt).masked_fill_(eye, float("inf")), dim=1,
                          stable=True)
    ranks = torch.empty_like(order).scatter_(
        1, order, torch.arange(1, n + 1, device=device).expand(n, n).contiguous())
    near = torch.argsort(torch.cdist(Et, Et).masked_fill_(eye, float("inf")), dim=1,
                         stable=True)[:, :k]
    t = float((torch.gather(ranks, 1, near) - k).clamp_min(0).sum())
    return 1.0 - t * (2.0 / (n * k * (2.0 * n - 3.0 * k - 1.0)))


def umap_epoch_bound(n: int, k: int, dim: int, nsr: int, itemsize: int) -> tuple:
    """(least ms of one SGD epoch on the card, "bytes"): the rows it
    gathers (each edge's tail and its nsr negative samples, dim values
    each), the edge list read once (int32 tails, frequencies) and the
    embedding read and written once, at 3.35 TB/s.  Its arithmetic (about
    30 operations an edge and 25 a sample) takes a tenth of that at
    67 TFLOP/s."""
    E = n * k
    nbytes = E * (1 + nsr) * dim * itemsize + E * (4 + itemsize) + 2 * n * dim * itemsize
    flops = 30.0 * E + 25.0 * E * nsr
    return bound(flops, _PEAK_FP32, nbytes)


def _fit_parts(parts: dict) -> str:
    keys = ("sample", "stage", "knn_graph", "smooth_knn_dist", "fuzzy_set", "supervised",
            "find_ab_params", "init", "sgd")
    return ", ".join(f"{k} {parts[k]:.3f}" for k in keys if k in parts)


def umap_aa(device, X, seed: int) -> tuple:
    """(aa) BASELINE.json configs[4]: a tenth of (x)'s 10M x 128 blobs
    (about 1M fit rows), n_neighbors 15, build_algo "auto" (NN-descent past
    50,000 rows), the auto epochs (200), spectral init, random_state 0;
    then 10,000 held-out rows transformed (the fused kernel, k = 15), and
    trustworthiness on 5,000 of the fit's rows held at its floor."""
    from spark_rapids_ml_torch.models import umap as umap_models
    from spark_rapids_ml_torch.ops import fused_knn as fk
    from spark_rapids_ml_torch.ops import umap as umap_ops
    from spark_rapids_ml_torch.umap import UMAP

    t0 = _synced(device)
    model = UMAP(sample_fraction=UMAP_AA_FRACTION, n_neighbors=15, random_state=seed).fit(X)
    fit_s = _synced(device) - t0
    parts, dec = dict(umap_models.LAST_FIT), dict(umap_ops.LAST_KERNEL_DECISION)
    n, epochs = parts["n_rows"], parts["n_epochs"]
    emb = model.embedding_
    if parts["graph"] != "nn_descent" or emb.shape != (n, 2) or not np.isfinite(emb).all():
        raise AssertionError(f"(aa) fit: graph {parts['graph']}, embedding {emb.shape}, "
                             f"finite {np.isfinite(emb).all()}")
    epoch_ms = parts["sgd"] / epochs * 1e3
    bound_ms, _ = umap_epoch_bound(n, 15, 2, 5, 4)
    log(f"  (aa) fit of {n} of {X.shape[0]} rows x {X.shape[1]}: {fit_s:.3f} s; parts (s): "
        f"{_fit_parts(parts)}; SGD {epochs} epochs, {dec['kernel']} ({dec['decided_by']}), "
        f"{epoch_ms:.3f} ms an epoch against a {bound_ms:.4f} ms bound "
        f"({bound_ms / epoch_ms:.2%})")
    keep = np.random.default_rng(seed).random(X.shape[0]) < UMAP_AA_FRACTION
    Q = np.ascontiguousarray(X[np.flatnonzero(~keep)[:UMAP_QUERIES]])
    reset_counts()
    t0 = _synced(device)
    out = model.transform(Q)  # the first stages the training rows
    first_s = _synced(device) - t0
    t0 = _synced(device)
    out2 = model.transform(Q)
    warm_s = _synced(device) - t0
    launches = {"main": fk.LAUNCHES, "split": fk.SPLIT_LAUNCHES, "merge": fk.MERGE_LAUNCHES}
    if (min(launches.values()) < 1 or out.shape != (len(Q), 2) or not np.isfinite(out).all()
            or not np.array_equal(out, out2)):
        raise AssertionError(f"(aa) transform: launches {launches}, {out.shape}, or two "
                             "transforms differ")
    sub = np.random.default_rng(seed + 1).choice(n, UMAP_TRUST_ROWS, replace=False)
    trust = trustworthiness(model.raw_data_[sub], emb[sub], 15, device)
    log(f"  (aa) transform of {len(Q)} held-out rows (fused kernel, k = 15): first {first_s:.3f}"
        f" s (training rows staged), warm {warm_s:.3f} s, {len(Q) / warm_s:.1f} queries/s; "
        f"launches {launches}; trustworthiness {trust:.4f} on {UMAP_TRUST_ROWS} fit rows "
        f"(floor {UMAP_TRUST_FLOOR})")
    if trust < UMAP_TRUST_FLOOR:
        raise AssertionError(f"(aa) trustworthiness {trust:.4f} below {UMAP_TRUST_FLOOR}")
    cell = {"cell": "(aa) BASELINE.json configs[4], UMAP", "rows": list(X.shape),
            "fit_rows": n, "fit_s": fit_s, "parts_s": {k: v for k, v in parts.items()
                                                       if isinstance(v, float)},
            "graph": parts["graph"], "n_epochs": epochs, "kernel": dec,
            "epoch_ms": epoch_ms, "epoch_bound_ms": bound_ms,
            "transform_first_s": first_s, "transform_warm_s": warm_s,
            "transform_queries_per_s": len(Q) / warm_s, "transform_launches": launches,
            "trustworthiness": trust, "trust_floor": UMAP_TRUST_FLOOR}
    return cell, model, Q


def umap_bb(device) -> list:
    """(bb) bench.py's bench_umap cells: standard normal rows x 32,
    n_neighbors 15, no random_state (the measured probe decides the
    form): 100,000 rows and 100 epochs, 1,000,000 rows and 50 epochs."""
    from spark_rapids_ml_torch.models import umap as umap_models
    from spark_rapids_ml_torch.ops import umap as umap_ops
    from spark_rapids_ml_torch.umap import UMAP

    cells = []
    for n, epochs, rs in UMAP_BB:
        X = np.random.default_rng(rs).standard_normal((n, 32)).astype(np.float32)
        t0 = _synced(device)
        m = UMAP(n_neighbors=15, n_epochs=epochs).fit(X)
        fit_s = _synced(device) - t0
        parts, dec = dict(umap_models.LAST_FIT), dict(umap_ops.LAST_KERNEL_DECISION)
        if not np.isfinite(m.embedding_).all() or dec["warm_epoch_sec_generic"] is None:
            raise AssertionError(f"(bb) {n} x 32: not finite, or no probe: {dec}")
        sgd_epoch_ms = parts["sgd"] / epochs * 1e3
        bound_ms, _ = umap_epoch_bound(n, 15, 2, 5, 4)
        log(f"  (bb) {n} x 32, {epochs} epochs: fit {fit_s:.3f} s ({n / fit_s:.1f} rows/s); "
            f"parts (s): {_fit_parts(parts)}; probe: generic "
            f"{dec['warm_epoch_sec_generic'] * 1e3:.3f} ms, structured "
            f"{dec['warm_epoch_sec_structured'] * 1e3:.3f} ms a warm epoch -> {dec['kernel']} "
            f"({dec['decided_by']}); SGD {sgd_epoch_ms:.3f} ms an epoch, bound "
            f"{bound_ms:.4f} ms")
        cells.append({"cell": f"(bb) bench_umap {n}x32, {epochs} epochs", "fit_s": fit_s,
                      "rows_per_s": n / fit_s, "graph": parts["graph"],
                      "parts_s": {k: v for k, v in parts.items() if isinstance(v, float)},
                      "kernel": dec, "sgd_epoch_ms": sgd_epoch_ms,
                      "epoch_bound_ms": bound_ms})
    return cells


def umap_fused_entry(device, items_t, valid_t, queries_t, k: int, launches: int, X, Q,
                     what: str, seed: int) -> tuple:
    """The float32 fused function at one of UMAP's shapes: timed and held
    against its plain version twice.  On UMAP's own rows, (x)'s blobs: d2
    within 1e-5 of the norms the identity cancels and every differing id
    slot a tie (phase 13's rule; near ties are many on blobs this dense, so
    the share is recorded, not held).  At the same shape on unit-scale
    standard normal rows (phase 3's regime, here with queries among the
    items): the same d2 rule, and ids equal on 99.9% of slots, every other
    slot a tie.  Beside its bound and the
    library's matmul + topk.  Returns (the kernel entry, the main kernel's
    partial lists on UMAP's rows and their split count)."""
    import torch

    from spark_rapids_ml_torch.ops import fused_knn as fk

    n, d = items_t.shape
    q = queries_t.shape[0]
    ms = cuda_ms(lambda: fk.fused_topk_sqdist(items_t, valid_t, queries_t, k), reps=3)
    kd, kp = fk.fused_topk_sqdist(items_t, valid_t, queries_t, k)
    plain = {}

    def run_plain():
        plain["out"] = fk.fused_topk_sqdist_reference(items_t, valid_t, queries_t, k, bq=1024,
                                                      bn=8192)

    plain_ms = cuda_ms(run_plain, reps=1, warm=False)
    err = hold_at_blob_norms(f"(cc) fused function, {what}: kernel vs twin", kd, kp,
                             *plain["out"], X, Q)
    share = float((kp == plain["out"][1]).float().mean())
    del kd, kp, plain
    gen = torch.Generator(device=device).manual_seed(seed)
    Xn = torch.randn((n, d), generator=gen, device=device)
    Qn = Xn[:q].contiguous() if q < n else Xn
    vn = torch.ones(n, device=device)
    nd, npos = fk.fused_topk_sqdist(Xn, vn, Qn, k)
    td, tpos = fk.fused_topk_sqdist_reference(Xn, vn, Qn, k, bq=1024, bn=8192)
    name = f"(cc) fused function at the shape of {what}, standard normal rows: kernel vs twin"
    hold_at_blob_norms(name, nd, npos, td, tpos, Xn.cpu().numpy(), Qn.cpu().numpy())
    share_normal = float((npos == tpos).float().mean())
    if share_normal < 0.999:
        raise AssertionError(f"{name}: ids equal on {share_normal:.6f} of slots, below 0.999")
    del Xn, Qn, vn, nd, npos, td, tpos
    library_ms = cuda_ms(lambda: library_topk(items_t, queries_t, k, block=1024), reps=1,
                         warm=False)
    flops = 2.0 * q * n * d
    nbytes = 4.0 * (n * d + q * d + 2 * n) + 8.0 * q * k
    bound_ms, bound_by = bound(3 * flops, _PEAK_TF32, nbytes)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    splits = fk.auto_splits(n, q, k, sms)
    part_d, part_i = fk.topk_partials(items_t, valid_t, queries_t, k, splits)
    log(f"  (cc) fused_topk_sqdist, {what}: {ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}, "
        f"share {bound_ms / ms:.1%}); twin {plain_ms:.3f} ms; library matmul+topk "
        f"{library_ms:.3f} ms; launches on UMAP's path {launches}; S = {splits}")
    return entry("fused_knn_tf32", launches, err, ms, plain_ms, bound_ms, bound_by, library_ms,
                 f"{n}x{d} float32 items, {q} queries, k={k}, S={splits} ({what}); library_ms "
                 "in 1024-query blocks", ids_equal_share_blobs=share,
                 ids_equal_share_normal=share_normal), part_d, part_i, splits


def umap_cc(device, X10m, aa_model, Q, seed: int) -> tuple:
    """(cc) the fused kernel on UMAP's path: a brute-force fit of the first
    50,000 of (x)'s rows (build_algo "auto" takes brute force at this size:
    items = queries, k = 16), and a transform of (aa)'s 10,000 held-out rows
    with n_neighbors 40, which launches the k > 32 merge
    (`merge_partials_kernel<float>`); each launch counted, each kernel held
    against its plain version, the merge's device time from a CUDA graph."""
    import torch

    from spark_rapids_ml_torch.models import umap as umap_models
    from spark_rapids_ml_torch.ops import fused_knn as fk
    from spark_rapids_ml_torch.umap import UMAP

    Xc = np.ascontiguousarray(X10m[:UMAP_CC_ROWS])
    reset_counts()
    t0 = _synced(device)
    model = UMAP(n_neighbors=15, random_state=0).fit(Xc)
    fit_s = _synced(device) - t0
    fit_launches = {"main": fk.LAUNCHES, "split": fk.SPLIT_LAUNCHES, "merge": fk.MERGE_LAUNCHES}
    parts = dict(umap_models.LAST_FIT)
    if parts["graph"] != "brute_force_knn" or min(fit_launches.values()) < 1:
        raise AssertionError(f"(cc) fit: graph {parts['graph']}, launches {fit_launches}")
    log(f"  (cc) brute-force fit of {Xc.shape}: {fit_s:.3f} s; parts (s): {_fit_parts(parts)};"
        f" launches {fit_launches}")
    Xt = torch.as_tensor(Xc, device=device)
    ones = torch.ones(Xt.shape[0], device=device)
    kernels = [umap_fused_entry(device, Xt, ones, Xt, 16, fit_launches["main"], Xc, Xc,
                                f"UMAP's brute-force fit graph, {UMAP_CC_ROWS} x 128",
                                seed)[0]]
    del Xt, ones
    aa_model._set_params(n_neighbors=UMAP_CC_K)
    try:
        reset_counts()
        t0 = _synced(device)
        out = aa_model.transform(Q)
        t_s = _synced(device) - t0
        launches = {"main": fk.LAUNCHES, "split": fk.SPLIT_LAUNCHES, "merge": fk.MERGE_LAUNCHES}
    finally:
        aa_model._set_params(n_neighbors=15)
    if min(launches.values()) < 1 or not np.isfinite(out).all():
        raise AssertionError(f"(cc) transform at k = {UMAP_CC_K}: launches {launches}")
    log(f"  (cc) transform of {len(Q)} rows at n_neighbors {UMAP_CC_K}: {t_s:.3f} s; launches "
        f"{launches}")
    items_t, valid_t = aa_model._device_items[1][:2]
    Qt = torch.as_tensor(Q, device=device)
    fused, part_d, part_i, splits = umap_fused_entry(
        device, items_t, valid_t, Qt, UMAP_CC_K, launches["main"], aa_model.raw_data_, Q,
        f"(aa)'s transform at n_neighbors {UMAP_CC_K}", seed + 1)
    kernels.append(fused)
    merge = merge_entry(part_d, part_i, (Qt * Qt).sum(dim=1), UMAP_CC_K, launches["merge"])
    merge.update(name="merge_partials_kernel<float32>, k > 32",
                 shape=merge["shape"] + "; UMAP transform, its first launches on a real path")
    kernels.append(merge)
    cells = [{"cell": "(cc) the fused kernel on UMAP's path", "fit_rows": UMAP_CC_ROWS,
              "fit_s": fit_s, "fit_launches": fit_launches, "transform_k": UMAP_CC_K,
              "transform_s": t_s, "transform_launches": launches, "splits": splits}]
    return cells, kernels, model


def _spy_optimizer(store: dict, draws):
    """Wrap ops/umap.py's optimize_embedding for one fit: record its
    inputs, hand it `draws`.  Returns the function to put back."""
    from spark_rapids_ml_torch.ops import umap as umap_ops

    real = umap_ops.optimize_embedding

    def spy(*args, **kw):
        store["args"] = [a.detach().cpu().numpy() for a in args[:4]] + list(args[4:])
        store["kw"] = dict(kw)
        return real(*args, draws=draws, **kw)

    umap_ops.optimize_embedding = spy
    return real


def umap_dd(device, seed: int, cc_model, Xc) -> dict:
    """(dd) checks: a float64 fit on the card against the CPU (2,000 x 16
    blobs, the same draws handed to both, the structured form on both): the
    optimizer's inputs equal (init and edges bit for bit, weights, rho and
    sigma within 1e-12) and the card's optimizer from the CPU fit's inputs
    within 1e-9 of the CPU's embedding (6 epochs: the SGD grows last-place
    differences of exp and pow about tenfold an epoch); two random_state=0
    fits on the card bit-equal; a CSR fit equal to the dense fit of the same
    rows; save and load bit-equal; a cosine fit."""
    import scipy.sparse as sp
    import torch

    from spark_rapids_ml_torch import config, set_default_device
    from spark_rapids_ml_torch.ops import umap as umap_ops
    from spark_rapids_ml_torch.umap import UMAP, UMAPModel

    out = {"cell": "(dd) checks"}
    X64, _ = make_blobs(2000, 16, 8, 1.0, seed + 14)
    draws = [np.random.default_rng(seed + 15 + e).integers(0, 2000, (2000 * 15, 5))
             for e in range(UMAP_DD_EPOCHS)]
    kw = dict(n_neighbors=15, random_state=seed, n_epochs=UMAP_DD_EPOCHS, float32_inputs=False)
    got = {}
    config.set_config(umap_kernel="structured")
    try:
        for where in ("card", "cpu"):
            set_default_device(device if where == "card" else "cpu")
            store = {}
            real = _spy_optimizer(store, draws)
            try:
                got[where] = (UMAP(**kw).fit(X64), store)
            finally:
                umap_ops.optimize_embedding = real
        set_default_device(device)
        (mc, sc), (mh, sh) = got["card"], got["cpu"]
        for i in range(3):
            if not np.array_equal(sc["args"][i], sh["args"][i]):
                raise AssertionError(f"(dd) float64: optimizer input {i} differs card vs CPU")
        errs = {"weights": np.abs(sc["args"][3] - sh["args"][3]).max(),
                "rho": np.abs(mc.rho_ - mh.rho_).max(),
                "sigma": np.abs(mc.sigma_ - mh.sigma_).max()}
        emb = umap_ops.optimize_embedding(
            *(torch.as_tensor(a, device=device) for a in sh["args"][:4]), *sh["args"][4:],
            draws=draws, **sh["kw"])
        errs["optimizer"] = np.abs(emb.cpu().numpy() - mh.embedding_).max()
        errs["whole_fit_not_held"] = np.abs(mc.embedding_ - mh.embedding_).max()
    finally:
        config.reset_config()
        set_default_device(device)
    log(f"  (dd) float64 card against CPU, 2000 x 16, {UMAP_DD_EPOCHS} epochs, the same draws: "
        f"{errs} "
        "(limits 1e-12, 1e-12, 1e-12, 1e-9; the whole fit is not held: an edge whose weight "
        "sits one unit in the last place from a floor((e + 1) f) crossing is sampled in "
        "another epoch)")
    if max(errs["weights"], errs["rho"], errs["sigma"]) > 1e-12 or errs["optimizer"] > 1e-9:
        raise AssertionError(f"(dd) float64 card against CPU: {errs}")
    out["float64_card_vs_cpu"] = {k: float(v) for k, v in errs.items()}
    # two random_state=0 fits bit-equal (the structured form: no atomics)
    Xr, _ = make_blobs(20_000, 32, 20, 1.0, seed + 16)
    Xr = Xr.astype(np.float32)
    a = UMAP(n_neighbors=15, random_state=0, n_epochs=100).fit(Xr)
    form = umap_ops.LAST_KERNEL_DECISION["kernel"]
    b = UMAP(n_neighbors=15, random_state=0, n_epochs=100).fit(Xr)
    if not (form == "structured" and np.array_equal(a.embedding_, b.embedding_)
            and np.array_equal(a.transform(Xr[:1000]), b.transform(Xr[:1000]))):
        raise AssertionError(f"(dd) two random_state=0 fits differ (form {form})")
    log(f"  (dd) two random_state=0 fits of 20000 x 32 ({form}): bit-equal")
    # CSR against dense
    rng = np.random.default_rng(seed + 17)
    Xs = rng.normal(size=(5000, 64)).astype(np.float32)
    Xs[rng.random(Xs.shape) < 0.7] = 0.0
    ckw = dict(n_neighbors=15, random_state=0, n_epochs=50, init="random")
    m_s, m_d = UMAP(**ckw).fit(sp.csr_matrix(Xs)), UMAP(**ckw).fit(Xs)
    csr_err = float(np.abs(m_s.embedding_ - m_d.embedding_).max())
    t_err = float(np.abs(m_s.transform(sp.csr_matrix(Xs[:500])) - m_d.transform(Xs[:500])).max())
    log(f"  (dd) CSR fit against the dense fit of the same 5000 x 64 rows: max |diff| "
        f"{csr_err:.3e}, transform {t_err:.3e} (limit 1e-6)")
    if max(csr_err, t_err) > 1e-6:
        raise AssertionError(f"(dd) CSR fit differs from the dense fit: {csr_err}, {t_err}")
    out["csr_vs_dense"] = {"fit": csr_err, "transform": t_err}
    # save and load
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "umap")
        cc_model.save(path)
        loaded = UMAPModel.load(path)
        same = (np.array_equal(loaded.embedding_, cc_model.embedding_)
                and np.array_equal(loaded.transform(Xc[:1000]), cc_model.transform(Xc[:1000])))
    if not same:
        raise AssertionError("(dd) a loaded UMAP model differs from the saved one")
    log("  (dd) save, load, transform: bit-equal")
    # cosine
    cm = UMAP(n_neighbors=15, random_state=0, n_epochs=50, metric="cosine").fit(Xr[:5000])
    if cm.embedding_.shape != (5000, 2) or not np.isfinite(cm.embedding_).all():
        raise AssertionError("(dd) cosine fit")
    ct = cm.transform(Xr[5000:6000])
    if not np.isfinite(ct).all():
        raise AssertionError("(dd) cosine transform")
    log("  (dd) cosine fit of 5000 x 32 and its transform: finite")
    out["same_seed_bit_equal"] = out["save_load_bit_equal"] = True
    return out


def phase_umap(device, args, X10m) -> dict:
    """Phase 14: UMAP, (aa), (bb), (cc) and (dd)."""
    import torch

    from spark_rapids_ml_torch import config
    from spark_rapids_ml_torch.parallel import device_cache

    config.reset_config()
    device_cache.clear_device_cache()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    aa, aa_model, Q = umap_aa(device, X10m, args.seed)
    log(f"  (aa) done at {time.perf_counter() - t_phase:.1f} s")
    cells = [aa] + umap_bb(device)
    log(f"  (bb) done at {time.perf_counter() - t_phase:.1f} s")
    cc, kernels, cc_model = umap_cc(device, X10m, aa_model, Q, args.seed)
    del aa_model
    torch.cuda.empty_cache()
    log(f"  (cc) done at {time.perf_counter() - t_phase:.1f} s")
    cells += cc + [umap_dd(device, args.seed, cc_model, np.ascontiguousarray(
        X10m[:UMAP_CC_ROWS]))]
    log(f"  phase 14 {time.perf_counter() - t_phase:.1f} s")
    torch.cuda.empty_cache()
    return {"cells": cells, "kernels": kernels}


# ---- Sparse LogisticRegression (ELL) and resilience -------------------------

SPARSE_ROWS = 10_000_000
SPARSE_COLS = 1 << 18  # pyspark.ml HashingTF's default numFeatures
SPARSE_SUB_ROWS = 1_000_000
SPARSE_HELD_OUT = 10_000
SPARSE_GEN_ROWS = 1_000_000  # rows of one generator chunk, each with its own seed
CRITEO_INT, CRITEO_CAT = 13, 26  # the Criteo display-ads layout's fields
SPARSE_KW = dict(regParam=1e-6, elasticNetParam=0.0, maxIter=100, tol=1e-6,
                 standardization=True)
SPARSE_FF_CLASSES = 5
SPARSE_KILL_AT = 10
SPARSE_KMEANS_ROWS = 10_000_000
SPARSE_OOM_FREE = 200 << 20  # bytes the ballast leaves: less than one transform chunk


def criteo_chunk(seed: int, index: int, n: int, device):
    """Rows `index * SPARSE_GEN_ROWS ...` of the Criteo-layout generator, on
    the card: (vals (n, 39) float32, cols (n, 39) int32, present (n, 39)
    bool).  Each field hashes into its own column range (13 integer fields,
    present with probability 0.8, value log(2 + count), column by count; 26
    categorical fields, value 1, a skewed category), so a row's columns rise
    with its fields: canonical CSR, no duplicates.  A chunk has its own
    generator, so the first rows of a larger draw are a smaller draw."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed * 1_000_003 + index)
    fields = CRITEO_INT + CRITEO_CAT
    width = SPARSE_COLS // fields
    base = torch.arange(fields, device=device, dtype=torch.int64) * width
    u = torch.rand((n, fields), generator=g, device=device, dtype=torch.float64)
    scale = 2.0 ** (torch.arange(CRITEO_INT, device=device) % 8).to(torch.float64)
    count = torch.floor(-torch.log1p(-u[:, :CRITEO_INT]) * scale)
    offset = torch.empty((n, fields), dtype=torch.int64, device=device)
    offset[:, :CRITEO_INT] = count.to(torch.int64) % width
    offset[:, CRITEO_INT:] = torch.clamp((width * u[:, CRITEO_INT:] ** 3).to(torch.int64),
                                         max=width - 1)
    vals = torch.ones((n, fields), dtype=torch.float32, device=device)
    vals[:, :CRITEO_INT] = torch.log(2.0 + count).to(torch.float32)
    present = torch.ones((n, fields), dtype=torch.bool, device=device)
    present[:, :CRITEO_INT] = torch.rand((n, CRITEO_INT), generator=g, device=device) < 0.8
    return vals, (base + offset).to(torch.int32), present


def _planted(seed: int, classes: int, device):
    """The planted sparse weight vectors (classes, d) of the labels."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed * 7919 + classes)
    W = torch.randn((classes, SPARSE_COLS), generator=g, device=device)
    return W * (torch.rand((classes, SPARSE_COLS), generator=g, device=device) < 0.1)


def _chunk_margins(vals, cols, present, W):
    """(n, classes) margins of a chunk under W (classes, d)."""
    n, f = vals.shape
    g = W.T[cols.reshape(-1).long()].reshape(n, f, W.shape[0])
    return ((vals * present).unsqueeze(2) * g).sum(dim=1)


def criteo_csr(n: int, seed: int, device, classes: int = 2, first_chunk: int = 0,
               threshold=None):
    """n rows of the generator as host CSR (float32 values, int32 indices,
    canonical) and labels: binary labels are the planted margin plus
    logistic noise above its 0.75 quantile over these rows (about a quarter
    positive, as in the Kaggle Criteo set; `threshold` reuses a quantile),
    `classes` > 2 the argmax of a quarter of planted margins plus Gumbel
    noise.  Returns
    (csr, y, threshold, seconds on the card, seconds of the host copy)."""
    import scipy.sparse as sp
    import torch

    W = _planted(seed, classes, device)
    noise_g = torch.Generator(device=device).manual_seed(seed * 104729 + classes + first_chunk)
    data, indices, counts, scores = [], [], [], []
    t_card = t_copy = 0.0
    done = 0
    index = first_chunk
    while done < n:
        rows = min(SPARSE_GEN_ROWS, n - done)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vals, cols, present = criteo_chunk(seed, index, rows, device)
        m = _chunk_margins(vals, cols, present, W)
        u = torch.rand(m.shape, generator=noise_g, device=device).clamp_(1e-7, 1 - 1e-7)
        if classes == 2:
            score = m[:, 1] - m[:, 0] + torch.log(u[:, 0] / (1 - u[:, 0]))
        else:
            # planted margins a quarter of the Gumbel noise's scale: classes
            # that overlap, as clicks do, not a separable set
            score = 0.25 * m - torch.log(-torch.log(u))
        d_vals, d_cols = vals[present], cols[present]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        data.append(d_vals.cpu().numpy())
        indices.append(d_cols.cpu().numpy())
        counts.append(present.sum(dim=1).cpu().numpy())
        scores.append(score)
        t_copy += time.perf_counter() - t1
        t_card += t1 - t0
        done += rows
        index += 1
        del vals, cols, present, m, u, d_vals, d_cols
    score = torch.cat(scores)
    if classes == 2:
        if threshold is None:
            threshold = float(torch.kthvalue(score.cpu(), int(0.75 * n)).values)
        y = (score > threshold).to(torch.float64).cpu().numpy()
    else:
        y = torch.argmax(score, dim=1).to(torch.float64).cpu().numpy()
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.concatenate(counts), out=indptr[1:])
    csr = sp.csr_matrix((np.concatenate(data), np.concatenate(indices), indptr),
                        shape=(n, SPARSE_COLS))
    csr.has_canonical_format = True  # columns rise within each row by construction
    return csr, y, threshold, t_card, t_copy


def auc(scores, labels) -> float:
    """Area under the ROC curve (ties ranked by their mean)."""
    from scipy.stats import rankdata

    ranks = rankdata(scores)
    pos = labels > 0
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def ell_oracle_bound_ms(oracle) -> float:
    """Least ms of one evaluation of an `EllOracle`, each input read once
    and the output written once: the values and column ids (for the
    margins), the column-sorted values and their rows (for the gradient),
    the weights and labels as the oracle holds them, theta in and the
    gradient out in float64."""
    ins = (oracle.X, oracle.cols, oracle.sorted_vals, oracle.layout.rows, oracle.w_scaled,
           oracle.sgn if oracle.binomial else oracle.labels)
    nbytes = sum(t.numel() * t.element_size() for t in ins) + 2 * 8 * oracle.n_param
    return nbytes / _PEAK_BYTES_PER_S * 1e3


def _synced(device):
    import torch

    torch.cuda.synchronize(device)
    return time.perf_counter()


def _same_model(a: dict, b: dict) -> bool:
    return (np.array_equal(a["coef_"], b["coef_"]) and np.array_equal(a["intercept_"],
                                                                      b["intercept_"])
            and a["objective_history"] == b["objective_history"])


def _objective64(fi, coef, intercept, std, l2: float, l1: float, classes: int) -> float:
    """The objective of a model on the staged ELL rows, in float64 on the
    card: one evaluation of the float64 ELL oracle at the model's
    standardized coefficients (the scaling has no centring)."""
    import torch

    from spark_rapids_ml_torch.ops import logistic as lo
    from spark_rapids_ml_torch.ops import sparse as ops

    cols = fi.extra["ell_cols"]
    vals = ops.ell_scale_columns(fi.X.double(), cols, 1.0 / torch.as_tensor(std,
                                                                              device=fi.X.device))
    binomial = classes == 2
    oracle = lo.EllOracle(vals, cols, fi.w.double(), fi.y, classes, l2, True, binomial,
                          d=fi.pdesc.n)
    coef_s = np.asarray(coef, np.float64) * np.asarray(std, np.float64)
    theta = np.concatenate([coef_s.reshape(-1), np.asarray(intercept, np.float64).reshape(-1)])
    f, _ = oracle(theta)
    del oracle, vals
    return f + l1 * float(np.abs(coef_s).sum())


def _std_of(fi) -> np.ndarray:
    from spark_rapids_ml_torch.ops import sparse as ops

    _, std = ops.ell_weighted_moments(fi.X.double(), fi.extra["ell_cols"], fi.w.double(),
                                      fi.pdesc.n)
    return std.cpu().numpy()


def sparse_ee(device, seed: int, card: str, tmp: str) -> tuple:
    """(ee): the 10M x 2^18 binary fit, its layers, checkpoint cost, the
    float64 reference, the held-out transform.  Returns (cell, its first 1M
    rows, their labels, the model, (the held-out rows, their
    transform))."""
    import torch

    from spark_rapids_ml_torch import config
    from spark_rapids_ml_torch import resilience as res
    from spark_rapids_ml_torch.classification import LogisticRegression
    from spark_rapids_ml_torch.core import FitInput
    from spark_rapids_ml_torch.ops import logistic as lo
    from spark_rapids_ml_torch.ops import sparse as ops
    from spark_rapids_ml_torch.utils import _ArrayBatch

    rec = {"cell": f"(ee) sparse binary LogisticRegression {SPARSE_ROWS} x {SPARSE_COLS}",
           "card": card, "params": SPARSE_KW}
    csr, y, thr, t_card, t_copy = criteo_csr(SPARSE_ROWS, seed, device)
    rec.update(nnz=int(csr.nnz), positive_share=float(y.mean()), gen_card_s=t_card,
               gen_copy_s=t_copy)
    log(f"  (ee) {SPARSE_ROWS} rows, {csr.nnz:,} entries ({csr.nnz / SPARSE_ROWS:.2f} a row), "
        f"{y.mean():.4f} positive: made on the card {t_card:.2f} s, copied to the host as "
        f"CSR {t_copy:.2f} s")
    # the fit through the entry point, its staging kept for the layers
    # below and the host conversion and the staging timed inside it
    est = LogisticRegression(**SPARSE_KW)
    kept, conv = {}, {}
    real_conversion, real_stage = ops.ell_from_csr, est._stage_fit_input

    def timed_conversion(c):
        t = time.perf_counter()
        out = real_conversion(c)
        conv["s"], conv["K"] = time.perf_counter() - t, int(out[0].shape[1])
        conv["GB"] = (out[0].nbytes + out[1].nbytes) / 1e9
        return out

    def kept_stage(batch):
        t = time.perf_counter()
        kept["fi"] = real_stage(batch)
        kept["s"] = _synced(device) - t
        return kept["fi"]

    ops.ell_from_csr, est._stage_fit_input = timed_conversion, kept_stage
    try:
        lo.ORACLE_CALLS = 0
        t0 = _synced(device)
        model = est.fit((csr, y))
        rec["fit_public_s"] = _synced(device) - t0
    finally:
        ops.ell_from_csr = real_conversion
        del est._stage_fit_input
    rec["iterations"], rec["oracle_calls"] = model.summary.totalIterations, lo.ORACLE_CALLS
    a = model._get_model_attributes()
    fi = kept["fi"]
    rec.update(csr_to_ell_s=conv["s"], ell_K=conv["K"], ell_GB=conv["GB"],
               staging_s=kept["s"] - conv["s"])
    log(f"  (ee) fit through the entry point: {rec['fit_public_s']:.2f} s, "
        f"{rec['iterations']} iterations, {rec['oracle_calls']} oracle calls, objective "
        f"{model.objective!r}; in it the host CSR -> ELL {rec['csr_to_ell_s']:.2f} s (K = "
        f"{rec['ell_K']}, {rec['ell_GB']:.2f} GB) and the staging {rec['staging_s']:.2f} s")
    Xv, cv, d = fi.X, fi.extra["ell_cols"], fi.pdesc.n
    t0 = _synced(device)
    layout = ops.ell_column_layout(Xv, cv, d)
    rec["layout_s"] = _synced(device) - t0
    rec["entries"] = int(layout.rows.numel())
    rec["moments_ms"] = cuda_ms(lambda: ops.ell_weighted_moments(Xv, cv, fi.w, d, layout=layout),
                                reps=2)
    _, std = ops.ell_weighted_moments(Xv, cv, fi.w, d, layout=layout)
    oracle = lo.EllOracle(Xv, cv, fi.w, fi.y, 2, SPARSE_KW["regParam"], True, True, d,
                          layout=layout, inv_std=1.0 / std)
    theta = np.random.default_rng(seed).normal(scale=1e-3, size=oracle.n_param)
    th = torch.as_tensor(theta, dtype=oracle.dtype, device=device)
    m = oracle.margins(th)
    _, r = oracle.loss_and_residual(m)
    rec["oracle_ms"] = cuda_ms(lambda: oracle.value_and_grad(th), reps=5)
    rec["margins_ms"] = cuda_ms(lambda: oracle.margins(th), reps=5)
    rec["gradient_ms"] = cuda_ms(lambda: oracle.gradient(r), reps=5)
    t0 = time.perf_counter()
    for _ in range(5):
        oracle(theta)
    rec["oracle_call_ms"] = (time.perf_counter() - t0) / 5 * 1e3
    rec["oracle_bound_ms"] = ell_oracle_bound_ms(oracle)
    del oracle, m, r, layout, std
    log(f"  (ee) column layout (sort) {rec['layout_s']:.3f} s ({rec['entries']:,} entries); "
        f"moments {rec['moments_ms']:.2f} ms")
    log(f"  (ee) oracle per evaluation on the card {rec['oracle_ms']:.3f} ms (margins "
        f"{rec['margins_ms']:.3f}, gradient {rec['gradient_ms']:.3f}); bytes bound "
        f"{rec['oracle_bound_ms']:.3f} ms, share {rec['oracle_bound_ms'] / rec['oracle_ms']:.1%};"
        f" a call from the solver {rec['oracle_call_ms']:.3f} ms")

    # the entry point's fit beside its conversion and staging, then the same
    # fit of the staged rows with checkpoints
    rec["fit_staged_s"] = rec["fit_public_s"] - rec["csr_to_ell_s"] - rec["staging_s"]
    rec["ms_per_iteration"] = rec["fit_staged_s"] / max(rec["iterations"], 1) * 1e3
    rec["host_ms_per_iteration"] = (rec["fit_staged_s"] * 1e3 - rec["oracle_calls"]
                                    * rec["oracle_ms"]) / max(rec["iterations"], 1)
    ckpt_dir = os.path.join(tmp, "ee_ckpt")
    config.set_config(checkpoint_dir=ckpt_dir)
    saves0 = res.counts_snapshot().get("checkpoint_saves_total", 0)
    t0 = _synced(device)
    checked = est._run_fit_kernel(fi)
    rec["fit_checkpointed_s"] = _synced(device) - t0
    config.reset_config()
    rec["checkpoint_saves"] = res.counts_snapshot().get("checkpoint_saves_total", 0) - saves0
    n_param = d + 1
    state = {"w": np.zeros(n_param), "f": 0.0, "g": np.zeros(n_param),
             "S": np.zeros((10, n_param)), "Y": np.zeros((10, n_param)), "rho": np.zeros(10),
             "k": 0, "it": 1, "hist": np.zeros(101), "converged": False}
    path = res.checkpoint_file_for(ckpt_dir, "timing")
    t0 = time.perf_counter()
    for _ in range(5):
        res.save_checkpoint(path, "timing", state)
    rec["save_ms"] = (time.perf_counter() - t0) / 5 * 1e3
    res.clear_checkpoint(path)
    rec["checkpoint_bytes"] = 16 * 10 * n_param
    rec["checkpoint_overhead_s"] = rec["fit_checkpointed_s"] - rec["fit_staged_s"]
    log(f"  (ee) the fit beside the conversion and the staging {rec['fit_staged_s']:.2f} s "
        f"({rec['ms_per_iteration']:.2f} ms an iteration, {rec['host_ms_per_iteration']:.2f} of "
        f"it beside the oracle); the staged rows' fit with checkpoint_dir "
        f"{rec['fit_checkpointed_s']:.2f} s ({rec['checkpoint_saves']} saves, "
        f"overhead {rec['checkpoint_overhead_s']:.2f} s); one save of the optimizer state "
        f"({rec['checkpoint_bytes'] / 1e6:.1f} MB of S and Y) {rec['save_ms']:.1f} ms")
    if not _same_model(checked, a):
        raise AssertionError("(ee): fits of the same rows are not bit-equal")
    log("  (ee) two fits (the entry point's, the staged rows' with checkpoints) bit-equal: held")

    # the float64 fit on the card, the same rows
    fi64 = FitInput(**{**fi.__dict__, "X": fi.X.double(), "w": fi.w.double(),
                       "dtype": np.dtype(np.float64)})
    est64 = LogisticRegression(float32_inputs=False, **SPARSE_KW)
    t0 = _synced(device)
    ref64 = est64._fit_array(fi64)
    rec["fit_float64_s"] = _synced(device) - t0
    del fi64
    rec["objective"], rec["objective_float64_fit"] = a["objective"], ref64["objective"]
    rel = abs(a["objective"] - ref64["objective"]) / abs(ref64["objective"])
    rec.update(_hold("(ee)", "objective against the float64 fit", rel, 1e-5))
    std64 = _std_of(fi)
    obj = _objective64(fi, a["coef_"], a["intercept_"], std64, SPARSE_KW["regParam"], 0.0, 2)
    rec.update(_hold("(ee)", "objective against its float64 evaluation",
                     abs(a["objective"] - obj) / abs(obj), 1e-5))
    log(f"  (ee) float64 fit on the card {rec['fit_float64_s']:.2f} s, "
        f"{ref64['num_iters']} iterations, objective {ref64['objective']!r}")
    del fi

    # the held-out rows, transformed (densified chunk by chunk)
    Xh, yh, _, _, _ = criteo_csr(SPARSE_HELD_OUT, seed, device,
                                 first_chunk=SPARSE_ROWS // SPARSE_GEN_ROWS, threshold=thr)
    t0 = _synced(device)
    out = model.transform(Xh)
    rec["transform_s"] = time.perf_counter() - t0
    rec["transform_rows_per_s"] = SPARSE_HELD_OUT / rec["transform_s"]
    p1 = out["probability"][:, 1]
    rec["auc"] = auc(p1, yh)
    if not (np.isfinite(out["probability"]).all() and out["probability"].shape ==
            (SPARSE_HELD_OUT, 2) and rec["auc"] > 0.6):
        raise AssertionError("(ee): the transform's outputs are wrong")
    log(f"  (ee) transform of {SPARSE_HELD_OUT} held-out rows {rec['transform_s']:.2f} s "
        f"({rec['transform_rows_per_s']:,.0f} rows/s), AUC {rec['auc']:.4f}")

    sub, ysub = csr[:SPARSE_SUB_ROWS], y[:SPARSE_SUB_ROWS]
    del csr, y
    torch.cuda.empty_cache()
    rec["label_threshold"] = thr
    return rec, sub, ysub, model, (Xh, out)


def sparse_ee_owlqn(device, rec: dict, sub, ysub) -> None:
    """(ee)'s OWL-QN fit (elasticNetParam 1) on its first 1M rows, the
    objective held against its float64 evaluation; into `rec`."""
    import torch

    from spark_rapids_ml_torch.classification import LogisticRegression
    from spark_rapids_ml_torch.utils import _ArrayBatch

    est = LogisticRegression(**dict(SPARSE_KW, elasticNetParam=1.0))
    t0 = _synced(device)
    m1 = est.fit((sub, ysub))
    rec["owlqn_fit_s"] = _synced(device) - t0
    rec["owlqn_iterations"] = m1.summary.totalIterations
    rec["owlqn_zero_coefficients"] = int((m1.coef_ == 0).sum())
    fi1 = est._stage_fit_input(_ArrayBatch(X=sub, y=ysub))
    obj = _objective64(fi1, m1.coef_, m1.intercept_, _std_of(fi1), 0.0,
                       SPARSE_KW["regParam"], 2)
    rec.update(_hold("(ee) OWL-QN", "objective against its float64 evaluation",
                     abs(m1.objective - obj) / abs(obj), 1e-5))
    log(f"  (ee) OWL-QN (elasticNetParam 1) on the first {SPARSE_SUB_ROWS} rows: "
        f"{rec['owlqn_fit_s']:.2f} s, {rec['owlqn_iterations']} iterations, "
        f"{rec['owlqn_zero_coefficients']} of {m1.coef_.size} coefficients zero")
    del fi1
    torch.cuda.empty_cache()


def sparse_ff(device, seed: int, card: str) -> dict:
    """(ff): 5-class ELL fit on the first 1M rows of the generator: the
    objective held against a float64 fit of the same rows on the card and
    against its own float64 evaluation."""
    import torch

    from spark_rapids_ml_torch.classification import LogisticRegression
    from spark_rapids_ml_torch.core import FitInput
    from spark_rapids_ml_torch.utils import _ArrayBatch

    rec = {"cell": f"(ff) sparse multinomial LogisticRegression {SPARSE_SUB_ROWS} x "
                   f"{SPARSE_COLS}, {SPARSE_FF_CLASSES} classes", "card": card}
    X, y, _, _, _ = criteo_csr(SPARSE_SUB_ROWS, seed, device, classes=SPARSE_FF_CLASSES)
    est = LogisticRegression(**SPARSE_KW)
    t0 = _synced(device)
    model = est.fit((X, y))
    rec["fit_s"] = _synced(device) - t0
    rec["iterations"] = model.summary.totalIterations
    fi = est._stage_fit_input(_ArrayBatch(X=X, y=y))
    fi64 = FitInput(**{**fi.__dict__, "X": fi.X.double(), "w": fi.w.double(),
                       "dtype": np.dtype(np.float64)})
    t0 = _synced(device)
    ref64 = LogisticRegression(float32_inputs=False, **SPARSE_KW)._fit_array(fi64)
    rec["fit_float64_s"] = _synced(device) - t0
    del fi64
    obj = _objective64(fi, model.coef_, model.intercept_, _std_of(fi), SPARSE_KW["regParam"],
                       0.0, SPARSE_FF_CLASSES)
    del fi
    rec["objective"], rec["objective_float64_fit"] = model.objective, ref64["objective"]
    rec["iterations_float64_fit"], rec["objective_float64"] = ref64["num_iters"], obj
    rec.update(_hold("(ff)", "objective against the float64 fit",
                     abs(model.objective - ref64["objective"]) / abs(ref64["objective"]), 1e-5))
    rec.update(_hold("(ff)", "objective against its float64 evaluation",
                     abs(model.objective - obj) / abs(obj), 1e-5))
    log(f"  (ff) fit {rec['fit_s']:.2f} s, {rec['iterations']} iterations, objective "
        f"{model.objective!r}; the float64 fit {rec['fit_float64_s']:.2f} s, "
        f"{ref64['num_iters']} iterations, objective {ref64['objective']!r}")
    torch.cuda.empty_cache()
    return rec


STICKY_CHILD = r'''
import time
t0 = time.perf_counter()
import json, os, sys
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke
from spark_rapids_ml_torch import config, resilience, set_default_device
from spark_rapids_ml_torch.classification import LogisticRegression
from spark_rapids_ml_torch.resilience import faults

device = torch.device("cuda:0")
set_default_device(device)
torch.ones(1, device=device).sum().item()
stamps = {"import_and_cuda_s": time.perf_counter() - t0}
mode, ckpt, out = sys.argv[2], sys.argv[3], sys.argv[4]
X, y, _, _, _ = chip_smoke.criteo_csr(chip_smoke.SPARSE_SUB_ROWS, int(sys.argv[5]), device,
                                      threshold=float(sys.argv[6]))
stamps["data_s"] = time.perf_counter() - t0 - stamps["import_and_cuda_s"]
config.set_config(checkpoint_dir=ckpt)
if mode == "kill":
    seen = {"n": 0}
    real = faults.maybe_inject

    def poison(site):
        if site == "lbfgs_iteration":
            seen["n"] += 1
            if seen["n"] == chip_smoke.SPARSE_KILL_AT + 1:
                # an index out of range on the card: a real device-side assert
                t = torch.zeros(4, device=device)
                t[torch.tensor([1 << 20], device=device)] += 1.0
                torch.cuda.synchronize()
        real(site)

    faults.maybe_inject = poison
    try:
        LogisticRegression(**chip_smoke.SPARSE_KW).fit((X, y))
    except Exception as e:
        stamps["to_the_error_s"] = time.perf_counter() - t0
        print(json.dumps({"error": str(e).splitlines()[0],
                          "action": resilience.classify_error(e),
                          "sticky": resilience.is_sticky_cuda_error(e),
                          "files": sorted(os.listdir(ckpt)), "stamps": stamps}), flush=True)
        os._exit(3)
    sys.exit(4)
m = LogisticRegression(**chip_smoke.SPARSE_KW).fit((X, y))
import numpy as np
np.savez(out, coef=m.coef_, intercept=m.intercept_, hist=np.asarray(m.summary.objectiveHistory))
stamps["to_the_end_s"] = time.perf_counter() - t0
print(json.dumps({"resumed": [e.detail for e in resilience.get_events("lbfgs_resume")],
                  "stamps": stamps}), flush=True)
'''


def _start_child(tmp: str, mode: str, ckpt: str, out: str, seed: int, threshold: float):
    """Start STICKY_CHILD in a fresh process, its output into files in
    `tmp`; `_finish_child` waits for it."""
    script = os.path.join(tmp, "sticky_child.py")
    with open(script, "w") as f:
        f.write(STICKY_CHILD)
    root = os.path.dirname(os.path.abspath(__file__))
    logs = [open(os.path.join(tmp, f"child_{mode}.{k}"), "w+") for k in ("out", "err")]
    proc = subprocess.Popen([sys.executable, script, root, mode, ckpt, out, str(seed),
                             repr(threshold)], stdout=logs[0], stderr=logs[1], text=True)
    return proc, logs, time.perf_counter()


def _child_json(child, timeout: float = 300.0) -> tuple:
    """(the child's last JSON line, seconds) as soon as it is printed: a
    child that met a device-side assert prints its line, then spends tens
    of seconds tearing its CUDA context down; `_finish_child` reaps it."""
    proc, logs, t0 = child
    while True:
        with open(logs[0].name) as f:
            last = [ln for ln in f.read().splitlines() if ln.startswith("{")]
        if last:
            return json.loads(last[-1]), time.perf_counter() - t0
        if proc.poll() is not None or time.perf_counter() - t0 > timeout:
            return {}, time.perf_counter() - t0
        time.sleep(0.2)


def _finish_child(child) -> tuple:
    """(exit code, its last JSON line, seconds, the end of its stderr)."""
    proc, logs, t0 = child
    try:
        code = proc.wait(timeout=300)
    except subprocess.TimeoutExpired:
        proc.kill()
        code = proc.wait()
    seconds = time.perf_counter() - t0
    texts = []
    for f in logs:
        f.seek(0)
        texts.append(f.read())
    last = [ln for ln in texts[0].splitlines() if ln.startswith("{")]
    return code, json.loads(last[-1]) if last else {}, seconds, texts[1][-2000:]


def sparse_gg(device, seed: int, card: str, tmp: str, sub, ysub, model, held_out, ee: dict,
              children: list, sticky_ckpt: str, sticky_out: str) -> dict:
    """(gg): resilience on the card, 1-5; the first child of 4 already
    runs."""
    import torch

    from spark_rapids_ml_torch import DeviceDataset, config
    from spark_rapids_ml_torch import resilience as res
    from spark_rapids_ml_torch.classification import LogisticRegression
    from spark_rapids_ml_torch.clustering import KMeans
    from spark_rapids_ml_torch.utils import _ArrayBatch

    rec = {"cell": "(gg) resilience on the card", "card": card}
    fast = dict(retry_backoff_s=0.01, retry_jitter=0.0)

    # 4. the sticky error's child has classified its error (it then tears its
    # context down for tens of seconds, reaped later); the resuming child
    # runs beside 1, 5 and 3; 2 runs last, with no child on the card (its
    # ballast would starve one, and a context freed mid-test would feed it)
    info, error_s = _child_json(children[0])
    if info.get("action") != "device_loss" or not info.get("sticky") or not info.get("files"):
        raise AssertionError(f"(gg) 4: the child did not classify a device loss: {info}")
    children.append(_start_child(tmp, "resume", sticky_ckpt, sticky_out, seed,
                                 ee["label_threshold"]))

    # 1. a resume after a crash
    est = LogisticRegression(**SPARSE_KW)
    t0 = _synced(device)
    ref = est.fit((sub, ysub))
    rec["fit_1m_s"] = _synced(device) - t0
    want = ref._get_model_attributes()
    ckpt = os.path.join(tmp, "gg_ckpt")
    res.reset_faults()
    res.reset_metrics()
    config.set_config(checkpoint_dir=ckpt, **fast,
                      fault_inject_spec=f"lbfgs_iteration:preemption:1:{SPARSE_KILL_AT}")
    healed = LogisticRegression(**SPARSE_KW).fit((sub, ysub))
    resumed = [e.detail for e in res.get_events("lbfgs_resume")]
    if resumed != [f"it={SPARSE_KILL_AT}"] or not _same_model(healed._get_model_attributes(),
                                                              want):
        raise AssertionError(f"(gg) 1: the retried fit did not resume bit-equal ({resumed})")
    rec["retry_resume_report"] = healed.fit_report().get("resilience")
    res.reset_faults()
    res.reset_metrics()
    config.set_config(checkpoint_dir=ckpt, retry_max_attempts=1,
                      fault_inject_spec=f"lbfgs_iteration:preemption:1:{SPARSE_KILL_AT}")
    try:
        LogisticRegression(**SPARSE_KW).fit((sub, ysub))
        raise AssertionError("(gg) 1: the fit was not killed")
    except res.SimulatedPreemption:
        pass
    config.set_config(checkpoint_dir=ckpt)
    again = LogisticRegression(**SPARSE_KW).fit((sub, ysub))
    resumed = [e.detail for e in res.get_events("lbfgs_resume")]
    if resumed != [f"it={SPARSE_KILL_AT}"] or not _same_model(again._get_model_attributes(),
                                                              want):
        raise AssertionError(f"(gg) 1: the new estimator did not resume bit-equal ({resumed})")
    config.reset_config()
    res.reset_faults()
    log(f"  (gg) 1: a preemption at iteration {SPARSE_KILL_AT} retried within the fit and a "
        f"fit killed there resumed by a new estimator: both bit-equal to the uninterrupted "
        f"fit ({rec['fit_1m_s']:.2f} s): held; at (ee)'s {SPARSE_ROWS} rows a save "
        f"{ee['save_ms']:.1f} ms, the fit's checkpoint overhead {ee['checkpoint_overhead_s']:.2f}"
        f" s of {ee['fit_staged_s']:.2f} s")

    # 5. KMeans on (h)'s generator (beside the resuming child)
    gen = torch.Generator(device=device).manual_seed(seed)
    X = torch.randn((SPARSE_KMEANS_ROWS, 64), generator=gen, device=device, dtype=torch.float32)
    ds = DeviceDataset(device, X, SPARSE_KMEANS_ROWS, weight=torch.ones(SPARSE_KMEANS_ROWS,
                                                                         device=device))
    kw = dict(k=20, seed=0, maxIter=20)
    ckpt = os.path.join(tmp, "gg_kmeans")
    config.set_config(checkpoint_dir=ckpt, **fast)
    t0 = _synced(device)
    k0 = KMeans(**kw).fit(ds)
    rec["kmeans_fit_s"] = _synced(device) - t0
    k0b = KMeans(**kw).fit(ds)
    res.reset_faults()
    res.reset_metrics()
    config.set_config(fault_inject_spec="kmeans_lloyd:preemption:1:5")
    k1 = KMeans(**kw).fit(ds)
    config.reset_config()
    res.reset_faults()
    resumed = [e.detail for e in res.get_events("kmeans_resume")]
    twice = _rel(k0b.cluster_centers_, k0.cluster_centers_)
    diff = _rel(k1.cluster_centers_, k0.cluster_centers_)
    rec.update(kmeans_resumed=resumed, kmeans_two_fits_rel=twice, kmeans_resumed_rel=diff,
               kmeans_bit_equal=bool(np.array_equal(k1.cluster_centers_, k0.cluster_centers_)),
               kmeans_iterations=(k0.n_iter_, k0b.n_iter_, k1.n_iter_),
               kmeans_cost_rel=abs(k1.inertia_ - k0.inertia_) / k0.inertia_)
    log(f"  (gg) 5: KMeans k=20 on {SPARSE_KMEANS_ROWS} x 64 ({rec['kmeans_fit_s']:.2f} s a fit,"
        f" stepwise): resumed {resumed}; iterations {rec['kmeans_iterations']}; centres "
        f"{diff:.3e} from the uninterrupted fit's (bit-equal {rec['kmeans_bit_equal']}), two "
        f"uninterrupted fits {twice:.3e} apart (index_add_'s atomics), cost "
        f"{rec['kmeans_cost_rel']:.3e} apart")
    del X, ds, k0, k0b, k1
    torch.cuda.empty_cache()
    if resumed != ["it=5"] or rec["kmeans_iterations"][2] != rec["kmeans_iterations"][0]:
        raise AssertionError(f"(gg) 5: no resume at iteration 5, or another iteration count")
    # Lloyd on rows with no clusters carries a rounding of the atomics'
    # order from pass to pass: the resumed fit is held to the spread of two
    # uninterrupted fits, its cost to float32's 1e-5
    rec.update(_hold("(gg) 5", "resumed centres' distance over two uninterrupted fits'",
                     diff / max(twice, 1e-6), 10.0))
    rec.update(_hold("(gg) 5", "resumed cost against the uninterrupted fit's",
                     rec["kmeans_cost_rel"], 1e-5))

    # 3. the watchdog around real card work (beside the resuming child): a
    # deadline a quarter of the 1M-row fit's time on the staged rows; the
    # next fit, a small one without a deadline, runs beside the abandoned
    # fit, whose end is awaited before 2
    t0 = time.perf_counter()
    fi = est._stage_fit_input(_ArrayBatch(X=sub, y=ysub))
    stage_s = _synced(device) - t0
    deadline = max(0.05, (rec["fit_1m_s"] - stage_s) / 4)
    rng = np.random.default_rng(seed)
    Xs = rng.normal(size=(2000, 8))
    ys = (Xs[:, 0] > 0).astype(np.float64)
    small = LogisticRegression(regParam=0.01).fit((Xs, ys))
    config.set_config(dispatch_deadline_s=deadline, retry_max_attempts=1)
    t0 = time.perf_counter()
    try:
        est._run_fit_kernel(fi)
        raise AssertionError("(gg) 3: no DispatchTimeout")
    except res.DispatchTimeout:
        rec["watchdog_s"] = time.perf_counter() - t0
    config.reset_config()
    rec.update(watchdog_deadline_s=deadline)
    if rec["watchdog_s"] > deadline + 2.0:
        raise AssertionError("(gg) 3: the timeout came late")
    t0 = _synced(device)
    after = LogisticRegression(regParam=0.01).fit((Xs, ys))
    rec["after_watchdog_fit_s"] = _synced(device) - t0
    if not np.array_equal(after.coef_, small.coef_):
        raise AssertionError("(gg) 3: the fit after the timeout differs")
    t_abandoned = time.perf_counter()
    del fi
    log(f"  (gg) 3: deadline {deadline:.3f} s on the {SPARSE_SUB_ROWS}-row fit: DispatchTimeout "
        f"after {rec['watchdog_s']:.3f} s; the next fit (no deadline: beside the abandoned one) "
        f"{rec['after_watchdog_fit_s']:.2f} s, equal to the same fit before: held")

    code, info2, resume_s, err = _finish_child(children[1])
    if code != 0:
        raise AssertionError(f"(gg) 4: the resuming child failed: {err}")
    code, _, kill_s, err = _finish_child(children[0])
    if code != 3:
        raise AssertionError(f"(gg) 4: the child did not end as a device loss: {code} {err}")
    with np.load(sticky_out) as z:
        got = {"coef_": z["coef"], "intercept_": z["intercept"],
               "objective_history": [float(v) for v in z["hist"]]}
    if info2.get("resumed") != [f"it={SPARSE_KILL_AT}"] or not _same_model(got, want):
        raise AssertionError(f"(gg) 4: the second child did not resume bit-equal: {info2}")
    rec.update(sticky_error=info["error"], sticky_child_s=kill_s,
               sticky_child_to_its_line_s=error_s, resume_child_s=resume_s,
               sticky_child_stamps=info.get("stamps"), resume_child_stamps=info2.get("stamps"))
    log(f"  (gg) 4: child 1 (its line after {error_s:.1f} s, its exit after {kill_s:.1f} s; "
        f"beside OWL-QN, (ff), 1, 5 and 3) ended on '{info['error']}', "
        f"classified {info['action']}, leaving {info['files']}; child 2 ({resume_s:.1f} s, "
        f"beside 1, 5 and 3) "
        f"resumed at iteration {SPARSE_KILL_AT}, bit-equal to the uninterrupted fit: held; "
        f"their stages {info.get('stamps')}, {info2.get('stamps')}")

    # 3's abandoned fit ends on its own, beside 4's end; 2 waits for it
    if res.wait_abandoned(120.0):
        raise AssertionError("(gg) 3: the abandoned fit did not end")
    rec["abandoned_end_s"] = time.perf_counter() - t_abandoned
    log(f"  (gg) 3: the abandoned fit had ended {rec['abandoned_end_s']:.2f} s after the next "
        "fit, at the latest")

    # 2. a real OOM in the transform, against (ee)'s transform of the rows
    Xh, plain = held_out
    torch.cuda.empty_cache()
    free, _ = torch.cuda.mem_get_info(device)
    ballast = torch.empty(int(free) - SPARSE_OOM_FREE, dtype=torch.uint8, device=device)
    res.reset_metrics()
    try:
        t0 = time.perf_counter()
        tight = model.transform(Xh)
        rec["oom_transform_s"] = time.perf_counter() - t0
    finally:
        del ballast
        torch.cuda.empty_cache()
    halvings = [e.detail for e in res.get_events("retry[transform_dispatch]")]
    rec["oom_retries"] = halvings
    if not halvings or not all("action=oom" in h for h in halvings):
        raise AssertionError(f"(gg) 2: no OOM was met or recovered ({halvings})")
    # every row once, in order; the margins of smaller chunks may take
    # another cuBLAS reduction, so the floats are held to float32's 1e-5
    if not np.array_equal(tight["prediction"], plain["prediction"]):
        raise AssertionError("(gg) 2: predictions after the OOM differ")
    for col in ("probability", "rawPrediction"):
        rec.update(_hold("(gg) 2", f"{col} against the unconstrained transform",
                         _rel(tight[col], plain[col]), 1e-5))
    from spark_rapids_ml_torch.streaming import chunk_rows_for

    first = chunk_rows_for(SPARSE_COLS, 4) // 2
    log(f"  (gg) 2: ballast left {SPARSE_OOM_FREE >> 20} MiB free, under one transform chunk "
        f"({first} rows, {first * SPARSE_COLS * 4 >> 20} MiB): {len(halvings)} OOM(s) recovered by "
        f"halving, {rec['oom_transform_s']:.2f} s, predictions equal to the unconstrained "
        "transform's: held")

    return rec


def phase_sparse_resilience(device, args, card: str) -> dict:
    """Phase 15: (ee), (ff), (gg)."""
    import shutil

    import torch

    from spark_rapids_ml_torch import config
    from spark_rapids_ml_torch.parallel import device_cache

    config.reset_config()
    device_cache.clear_device_cache()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_sparse_")
    children: list = []
    try:
        ee, sub, ysub, model, held_out = sparse_ee(device, args.seed, card, tmp)
        log(f"  (ee) done at {time.perf_counter() - t_phase:.1f} s")
        # (gg) 4's first child (a sticky CUDA error) runs beside (ee)'s OWL-QN
        # fit, (ff) and (gg) 1: its start-up and its fit overlap the parent's
        # work on the card
        sticky_ckpt = os.path.join(tmp, "gg_sticky")
        os.makedirs(sticky_ckpt, exist_ok=True)
        sticky_out = os.path.join(tmp, "gg_sticky_model.npz")
        children.append(_start_child(tmp, "kill", sticky_ckpt, sticky_out, args.seed,
                                     ee["label_threshold"]))
        sparse_ee_owlqn(device, ee, sub, ysub)
        ff = sparse_ff(device, args.seed, card)
        log(f"  (ff) done at {time.perf_counter() - t_phase:.1f} s")
        gg = sparse_gg(device, args.seed, card, tmp, sub, ysub, model, held_out, ee, children,
                       sticky_ckpt, sticky_out)
    finally:
        for proc, logs, _ in children:  # stop a child a failed check left running
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            for f in logs:
                f.close()
        shutil.rmtree(tmp, ignore_errors=True)
        config.reset_config()
    log(f"  phase 15 {time.perf_counter() - t_phase:.1f} s")
    return {"cells": [ee, ff, gg]}


# Phase 16: the serving path (serving/).  (hh) bench.py's bench_serving at
# full width, (ii) bench_serving_scale's 200 pinned models, (jj) faults and
# bench_serving_control's brownout, cut to fit the phase.
SERVE_REQUESTS = 300  # one-row requests per model in (hh), bench_serving's count
SERVE_LR_ROWS = 100_000  # (hh)'s LogisticRegression fit rows, of (b)'s generator
SERVE_K = 32  # (hh)'s kNN, phase 3's k over phase 3's 1M x 128 items
SERVE_QS = (1, 8, 64)  # the served batch sizes of the fused kernel's rows
SMALLQ_SWEEP = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)  # the q of the route sweep
SERVE_SCALE_MODELS = 200
SERVE_SCALE_REQUESTS = 2000
SERVE_SCALE_DIM = 64


def _serving_util() -> dict:
    """The serving utilization timeline since its last clear: the card's
    busy and idle shares (a batch is busy from its dispatch to its CUDA
    event observed complete, so the idle share is a lower bound)."""
    from spark_rapids_ml_torch.telemetry import utilization

    u = utilization.summarize(domain="serving")
    if not u:
        return {"idle_share": None}
    return {"busy_share": u["device_busy_fraction"],
            "idle_share": round(1.0 - u["device_busy_fraction"], 4),
            "wall_s": u["wall_s"],
            "gaps": [(r["kind"], r.get("cause", ""), r["stolen_s"])
                     for r in u["gap_attribution"][:4]]}


def _settled(server) -> None:
    """Wait for the collect worker to count the last batch (its futures
    resolve just before)."""
    deadline = time.time() + 10
    while server.pipeline_info()["inflight"] and time.time() < deadline:
        time.sleep(0.001)


def _hold_outputs(name: str, got: dict, want: dict) -> float:
    """A served output against the model's own transform of the same rows
    on the card: float columns within 1e-5 of the column's largest
    magnitude (the served batches pad to other row counts than the whole
    block, so cuBLAS may sum in another order), discrete columns equal but
    where a float column shows a tie (a probability within 1e-6 of 0.5)."""
    worst = 0.0
    for col, w in want.items():
        g, w = np.asarray(got[col]), np.asarray(w)
        if g.shape != w.shape:
            raise AssertionError(f"(hh) {name}.{col}: shape {g.shape} != {w.shape}")
        if np.issubdtype(w.dtype, np.floating):
            err = float(np.abs(g.astype(np.float64) - w).max()) if w.size else 0.0
            if not err <= 1e-5 * max(1.0, float(np.abs(w).max())):
                raise AssertionError(f"(hh) {name}.{col}: served differs by {err:.3e}")
            worst = max(worst, err)
    for col, w in want.items():
        w, g = np.asarray(w), np.asarray(got[col])
        if np.issubdtype(w.dtype, np.floating):
            continue
        bad = np.nonzero(g != w)[0]
        probs = want.get("probability")
        if bad.size and (probs is None or not np.all(np.abs(probs[bad] - 0.5).min(-1) < 1e-6)):
            raise AssertionError(f"(hh) {name}.{col}: {bad.size} rows differ")
    return worst


def _knn_transform(model, dtype):
    """A served kNN model's transform: `_search` on the rows in `dtype`;
    `transform.rows` lists the rows of each call."""
    def transform(Q):
        transform.rows.append(len(Q))
        dist, pos = model._search(np.asarray(Q, dtype), SERVE_K)
        return {"distances": dist, "indices": pos}

    transform.rows = []
    return transform


def _hold_knn(name: str, got: dict, want: dict, err_limit: float, tie_tol: float) -> float:
    """Served kNN answers against the model's own search of the same rows:
    distances within err_limit, and ids equal but at ties (a differing
    slot's distance equals the reference's within tie_tol, relative and
    absolute: the kernel's rounding)."""
    g, w = got["distances"].astype(np.float64), want["distances"].astype(np.float64)
    err = float(np.abs(g - w).max())
    diff = got["indices"] != want["indices"]
    tie = np.isclose(g[diff], w[diff], rtol=tie_tol, atol=tie_tol)
    if err > err_limit or not tie.all():
        raise AssertionError(f"(hh) {name}: served differs (d err {err:.3e}, "
                             f"{int((~tie).sum())} id slots not ties)")
    return err


def serve_hh(device, lr_X, lr_y, knn_model, seed: int, card: str) -> tuple:
    """(hh): bench_serving at full width through the entry points, a
    float64 kNN model beside the float32 one, and the fused kernel's rows at
    the served batch sizes in both types."""
    import torch

    from spark_rapids_ml_torch import config
    from spark_rapids_ml_torch.classification import LogisticRegression
    from spark_rapids_ml_torch.feature import PCA
    from spark_rapids_ml_torch.knn import NearestNeighbors
    from spark_rapids_ml_torch.ops import fused_knn as fk
    from spark_rapids_ml_torch.serving import ServingServer
    from spark_rapids_ml_torch.telemetry import utilization

    t0 = time.perf_counter()
    lr = LogisticRegression(maxIter=20).fit((lr_X, lr_y))
    t_lr = time.perf_counter() - t0
    items = knn_model.item_features
    t0 = time.perf_counter()
    pca = PCA(k=3).setInputCol("features").setOutputCol("proj").fit({"features": items})
    t_pca = time.perf_counter() - t0
    t0 = time.perf_counter()
    knn64 = NearestNeighbors(k=SERVE_K, float32_inputs=False).fit(
        {"features": items.astype(np.float64)})
    t_knn64 = time.perf_counter() - t0
    log(f"  (hh) fits: LogisticRegression {lr_X.shape[0]} x {lr_X.shape[1]} {t_lr:.2f} s, "
        f"PCA k=3 {items.shape[0]} x {items.shape[1]} {t_pca:.2f} s, float64 "
        f"NearestNeighbors k={SERVE_K} on the float64 copy of the items {t_knn64:.2f} s")

    # name: (model, transform, width, request dtype, kNN tolerances: the
    # distances' absolute error, a tie's; the distances are about 16)
    models = {"logreg": (lr, None, lr_X.shape[1], np.float32, None),
              "pca": (pca, None, items.shape[1], np.float32, None),
              "knn": (knn_model, _knn_transform(knn_model, np.float32), items.shape[1],
                      np.float32, (1e-4, 1e-5)),
              "knn64": (knn64, _knn_transform(knn64, np.float64), items.shape[1], np.float64,
                        (1e-9, 1e-10))}
    config.set_config(serving_max_wait_ms=5.0)  # bench_serving's
    server = ServingServer()
    for name, (m, fn, d, dt, _) in models.items():
        server.register(name, m, dtype=dt, n_features=d, transform=fn)
    server.start()
    rng = np.random.default_rng(seed + 160)
    cells, served_launches, served64 = [], None, None
    try:
        for name, (m, fn, d, dt, knn_tol) in models.items():
            reqs = [rng.standard_normal((1, d), dtype=np.float32).astype(dt)
                    for _ in range(SERVE_REQUESTS)]
            seq = fn or m._transform_array
            seq(reqs[0])
            server.transform(name, reqs[0], timeout=300)
            t0 = time.perf_counter()
            for r in reqs:
                seq(r)  # each call ends in a fetch to the host
            seq_s = time.perf_counter() - t0
            _settled(server)
            b0 = server.pipeline_info()["batches"]
            utilization.clear()
            if knn_tol:
                fn.rows.clear()
            reset_counts()
            t0 = time.perf_counter()
            futs = [server.submit(name, r) for r in reqs]
            outs = [f.result(timeout=300) for f in futs]
            srv_s = time.perf_counter() - t0
            batch_rows = list(fn.rows) if knn_tol else None  # the served batches' rows
            launches = {"main": fk.LAUNCHES, "smallq": fk.SMALLQ_LAUNCHES,
                        "main_f64": fk.LAUNCHES_F64, "smallq_f64": fk.SMALLQ_F64_LAUNCHES,
                        "split": fk.SPLIT_LAUNCHES, "merge": fk.MERGE_LAUNCHES}
            _settled(server)
            batches = server.pipeline_info()["batches"] - b0
            util = _serving_util()
            rep = server.report()[name]
            # the same burst again under torch.profiler: the share of its
            # wall the card spent in kernels
            prof_ms, busy = device_busy_share(
                lambda: [f.result(timeout=300) for f in [server.submit(name, r) for r in reqs]])
            want = seq(np.concatenate(reqs))
            got = {c: np.concatenate([o[c] for o in outs]) for c in outs[0]}
            if name == "knn":
                err = _hold_knn(name, got, want, *knn_tol)
                if launches["smallq"] < 1 or launches["main"] + launches["smallq"] != batches:
                    raise AssertionError(f"(hh) the served kNN route should launch the small-q "
                                         f"kernel (one main kernel a batch, {batches} "
                                         f"batches): {launches}")
                served_launches = dict(launches, batches=batches)
            elif name == "knn64":
                err = _hold_knn(name, got, want, *knn_tol)
                if launches["smallq_f64"] < batches or launches["main_f64"]:
                    raise AssertionError(f"(hh) the served float64 kNN route should launch the "
                                         f"float64 small-q kernel at least once a batch and "
                                         f"never the float64 main kernel ({batches} batches): "
                                         f"{launches}")
                served64 = dict(launches, batches=batches)
            else:
                err = _hold_outputs(name, got, want)
            cell = {
                "cell": f"(hh) {name}", "requests": SERVE_REQUESTS, "d": d,
                "seq_qps": SERVE_REQUESTS / seq_s, "qps": SERVE_REQUESTS / srv_s,
                "speedup_x": seq_s / srv_s, "p50_ms": rep.get("p50_ms"),
                "p99_ms": rep.get("p99_ms"), "batches": batches, "max_abs_err": err,
                "pipeline_depth": server.pipeline_info()["depth"], **util,
                "profiled_burst_ms": prof_ms, "kernel_busy_share": busy,
            }
            if knn_tol:
                cell.update(launches=launches, batch_rows_max=max(batch_rows))
            log(f"  (hh) {name}: sequential {cell['seq_qps']:.1f} q/s, served {cell['qps']:.1f} "
                f"q/s ({cell['speedup_x']:.2f}x) in {batches} batches, p50 "
                f"{cell['p50_ms']} ms, p99 {cell['p99_ms']} ms, depth "
                f"{cell['pipeline_depth']}, idle share {util['idle_share']} (timeline; "
                f"kernels {busy} of a profiled burst of {prof_ms:.1f} ms), max err "
                f"{err:.3e}" + (f", launches {launches}, the largest batch {max(batch_rows)} rows"
                                if knn_tol else "") + f" [{card}]")
            cells.append(cell)
        totals = server.report()["_totals"]
        log(f"  (hh) pinned bytes {totals['pinned_bytes']}, batches {totals['batches']}")
    finally:
        server.stop()
        server.registry.clear()
        config.reset_config()

    # the fused function at the served batch sizes, on the staged items the
    # served route searched: the route (the small-q kernel, then the merge)
    # against its twin and the 3xTF32 route, timed beside its bound, its
    # plain version and the library; the 3xTF32 route and the float64
    # function at the same sizes; the sweep that set fk._SMALL_Q
    items_t, valid_t, _ = knn_model._device_items[1]
    n, dim = items_t.shape[0], items_t.shape[1]
    per_batch = (served_launches["main"] + served_launches["smallq"]) / max(
        served_launches["batches"], 1)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    served = (f"launches are (hh)'s served run ({served_launches['batches']} batches: small-q "
              f"{served_launches['smallq']}, 3xTF32 {served_launches['main']}, split "
              f"{served_launches['split']}, merge {served_launches['merge']})")
    kernels, f64_cells = [], []
    for q in SERVE_QS:
        Qt = torch.as_tensor(rng.standard_normal((q, dim), dtype=np.float32), device=device)
        q2 = (Qt * Qt).sum(dim=1)
        if fk.route(q, SERVE_K, torch.float32) != "fused_knn_smallq":
            raise AssertionError(f"(hh) q={q}: the route does not take the small-q kernel")
        kd, kp = fk.fused_topk_sqdist(items_t, valid_t, Qt, SERVE_K)
        td, tp = fk.fused_topk_sqdist_reference(items_t, valid_t, Qt, SERVE_K, bq=1024, bn=8192)
        tf_splits = fk.auto_splits(n, q, SERVE_K, sms)

        def tf32_route():
            return fk.merge_partials(*fk.topk_partials(items_t, valid_t, Qt, SERVE_K, tf_splits),
                                     q2, SERVE_K)

        fd, fp = tf32_route()
        torch.cuda.synchronize()
        err = compare(f"(hh) served q={q}: small-q route vs twin", kd, kp, td, tp, exact=False)
        tf_err = compare(f"(hh) served q={q}: 3xTF32 route vs twin", fd, fp, td, tp, exact=False)
        host_items = knn_model.item_features
        compare_ties_aside(f"(hh) served q={q}: small-q route vs 3xTF32 route", kd, kp, fd, fp,
                           host_items, Qt.cpu().numpy(), exact=False)
        splits = fk.smallq_splits(n, q, fk.smallq_wave(device, q))
        ms = cuda_ms(lambda: fk.fused_topk_sqdist(items_t, valid_t, Qt, SERVE_K), reps=20)
        kernel_ms = graph_ms(lambda: fk.fused_knn_smallq(items_t, valid_t, Qt, SERVE_K, splits))
        part_d, part_i = fk.fused_knn_smallq(items_t, valid_t, Qt, SERVE_K, splits)
        merge_ms = graph_ms(lambda: fk.merge_partials(part_d, part_i, q2, SERVE_K))
        tf_ms = cuda_ms(tf32_route, reps=20)
        plain_ms = cuda_ms(lambda: fk.fused_topk_sqdist_reference(
            items_t, valid_t, Qt, SERVE_K, bq=1024, bn=8192), reps=2)
        library_ms = cuda_ms(lambda: library_topk(items_t, Qt, SERVE_K), reps=20)
        nbytes = 4.0 * (n * dim + q * dim + 2 * n) + 8.0 * q * SERVE_K
        bound_ms, bound_by = bound(3 * 2.0 * q * n * dim, _PEAK_TF32, nbytes)
        fp32_ms, fp32_by = bound(2.0 * q * n * dim, _PEAK_FP32, nbytes)
        sweep = {}
        for s in sorted({max(1, splits // 4), max(1, splits // 2), splits, 2 * splits}):
            sweep[s] = cuda_ms(lambda: fk.fused_topk_sqdist(items_t, valid_t, Qt, SERVE_K,
                                                            splits=s), reps=10)
        log(f"  (hh) fused_topk_sqdist at q={q} over {n} x {dim}, k={SERVE_K}: small-q route "
            f"{ms:.4f} ms (the kernel {kernel_ms:.4f} ms and the merge {merge_ms:.4f} ms on the "
            f"card, at S = {splits}) (bound {bound_ms:.4f} ms, {bound_by}, share "
            f"{bound_ms / ms:.1%}; at FP32 {fp32_ms:.4f} ms, {fp32_by}, share "
            f"{fp32_ms / ms:.1%}); 3xTF32 route {tf_ms:.4f} ms (S = {tf_splits}); twin "
            f"{plain_ms:.3f} ms; torch.matmul + torch.topk {library_ms:.4f} ms; "
            f"{per_batch:.2f} main-kernel launches a served batch [{card}]")
        log(f"  (hh) small-q route at q={q} by S: "
            + ", ".join(f"{s}: {t:.4f}" for s, t in sweep.items()))
        kernels.append(entry(
            "fused_knn_smallq_kernel", served_launches["smallq"], err, ms, plain_ms, bound_ms,
            bound_by, library_ms, f"served: {n}x{dim} float32 items, q={q}, k={SERVE_K}, "
            f"S={splits}; ms is the whole fused_topk_sqdist call (small-q kernel + merge); "
            + served + "; kernel_device_ms and merge_device_ms are one call in a CUDA graph; "
            "tf32_route_ms is split + 3xTF32 main kernel + merge on the same queries, called "
            "directly (the route no longer takes it at this q)",
            launches_per_batch=per_batch, kernel_device_ms=kernel_ms, merge_device_ms=merge_ms,
            fp32_bound_ms=fp32_ms, splits_sweep=sweep, tf32_route_ms=tf_ms,
            tf32_route_max_abs_err=tf_err, tf32_route_splits=tf_splits))
    # the sweep that set fk._SMALL_Q: both routes by q, called directly
    route_sweep = {}
    for q in SMALLQ_SWEEP:
        Qt = torch.as_tensor(rng.standard_normal((q, dim), dtype=np.float32), device=device)
        q2 = (Qt * Qt).sum(dim=1)
        s_sq = fk.smallq_splits(n, q, fk.smallq_wave(device, q))
        s_tf = fk.auto_splits(n, q, SERVE_K, sms)
        route_sweep[q] = (
            cuda_ms(lambda: fk.merge_partials(
                *fk.fused_knn_smallq(items_t, valid_t, Qt, SERVE_K, s_sq), q2, SERVE_K), reps=10),
            cuda_ms(lambda: fk.merge_partials(
                *fk.topk_partials(items_t, valid_t, Qt, SERVE_K, s_tf), q2, SERVE_K), reps=10))
    log(f"  (hh) routes by q at {n} x {dim}, k={SERVE_K}, ms small-q / 3xTF32 (fk._SMALL_Q = "
        f"{fk._SMALL_Q}): " + ", ".join(f"{q}: {a:.4f} / {b:.4f}"
                                         for q, (a, b) in route_sweep.items()) + f" [{card}]")
    f64_cells.append({"cell": "(hh) routes by q, ms small-q / 3xTF32",
                      "sweep": {str(q): list(t) for q, t in route_sweep.items()},
                      "small_q": fk._SMALL_Q})
    rows64, sweep64 = smallq_f64_rows(device, knn64, served64, rng, card)
    return cells + f64_cells + sweep64, kernels + rows64


def smallq_f64_rows(device, knn64, served: dict, rng, card: str) -> tuple:
    """The float64 function at the served batch sizes, on the float64
    model's staged items: the route (the float64 small-q kernel, then the
    merge) against its plain version and the float64 main-kernel route
    called directly, timed beside its bound, the plain version and
    torch.matmul + torch.topk in float64; then the sweep that set
    fk._SMALL_Q_F64.  Returns (kernel entries, cells)."""
    import torch

    from spark_rapids_ml_torch.ops import fused_knn as fk

    items64, valid64, _ = knn64._device_items[1]
    n, dim = items64.shape
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    per_batch = served["smallq_f64"] / max(served["batches"], 1)
    note = (f"launches are (hh)'s served float64 run ({served['batches']} batches: float64 "
            f"small-q {served['smallq_f64']}, float64 main {served['main_f64']}, merge "
            f"{served['merge']})")

    def main_route(Qt, q2, splits):
        # the float64 main kernel as the route ran it: the norms pass first
        return fk.merge_partials(*fk.fused_knn_f64(items64, Qt, fk.padded_item_norms(
            items64, valid64), SERVE_K, splits), q2, SERVE_K)

    entries, cells = [], []
    for q in SERVE_QS:
        Qt = torch.as_tensor(rng.standard_normal((q, dim)), device=device)
        q2 = (Qt * Qt).sum(dim=1)
        if fk.route(q, SERVE_K, torch.float64) != "fused_knn_smallq_f64":
            raise AssertionError(f"(hh) float64 q={q}: the route does not take the float64 "
                                 f"small-q kernel")
        splits = fk.smallq_splits(n, q, fk.smallq_wave(device, q, torch.float64),
                                  fk._SQ_QBLOCK_F64)
        main_splits = fk.auto_splits(n, q, SERVE_K, sms, torch.float64)
        kd, kp = fk.fused_topk_sqdist(items64, valid64, Qt, SERVE_K)
        td, tp = fk.fused_topk_sqdist_reference(items64, valid64, Qt, SERVE_K, bq=1024, bn=8192)
        md, mp = main_route(Qt, q2, main_splits)
        torch.cuda.synchronize()
        host_items, host_q = knn64.item_features, Qt.cpu().numpy()
        err = compare_ties_aside(f"(hh) float64 q={q}: small-q route vs its plain version", kd,
                                 kp, td, tp, host_items, host_q, exact=False)
        main_err = compare_ties_aside(f"(hh) float64 q={q}: main-kernel route vs its plain "
                                      "version", md, mp, td, tp, host_items, host_q, exact=False)
        ms = cuda_ms(lambda: fk.fused_topk_sqdist(items64, valid64, Qt, SERVE_K), reps=20)
        kernel_ms = graph_ms(lambda: fk.fused_knn_smallq_f64(items64, valid64, Qt, SERVE_K,
                                                             splits))
        part_d, part_i = fk.fused_knn_smallq_f64(items64, valid64, Qt, SERVE_K, splits)
        merge_ms = graph_ms(lambda: fk.merge_partials(part_d, part_i, q2, SERVE_K))
        main_ms = cuda_ms(lambda: main_route(Qt, q2, main_splits), reps=10)
        plain_ms = cuda_ms(lambda: fk.fused_topk_sqdist_reference(
            items64, valid64, Qt, SERVE_K, bq=1024, bn=8192), reps=2)
        library_ms = cuda_ms(lambda: library_topk(items64, Qt, SERVE_K), reps=10)
        # each input read once (items, validity, queries), the (q, k)
        # distances and int32 positions written once
        nbytes = 8.0 * (n * dim + n + q * dim) + 12.0 * q * SERVE_K
        bound_ms, bound_by = bound(2.0 * q * n * dim, _PEAK_FP64, nbytes)
        log(f"  (hh) float64 fused_topk_sqdist at q={q} over {n} x {dim}, k={SERVE_K}: small-q "
            f"route {ms:.4f} ms (the kernel {kernel_ms:.4f} ms and the merge {merge_ms:.4f} ms "
            f"on the card, at S = {splits}) (bound {bound_ms:.4f} ms, {bound_by}, share "
            f"{bound_ms / ms:.1%}); float64 main-kernel route {main_ms:.4f} ms (S = "
            f"{main_splits}); plain {plain_ms:.3f} ms; torch.matmul + torch.topk in float64 "
            f"{library_ms:.4f} ms ({library_ms / ms:.2f}x the route); {per_batch:.2f} float64 "
            f"small-q launches a served batch [{card}]")
        entries.append(entry(
            "fused_knn_smallq_f64_kernel", served["smallq_f64"], err, ms, plain_ms, bound_ms,
            bound_by, library_ms, f"served: {n}x{dim} float64 items, q={q}, k={SERVE_K}, "
            f"S={splits}; ms is the whole fused_topk_sqdist call (float64 small-q kernel + "
            "merge); " + note + "; kernel_device_ms and merge_device_ms are one call in a CUDA "
            "graph; main_route_ms is the norms pass + float64 main kernel + merge on the same "
            "queries, called directly (the route no longer takes it at this q)",
            launches_per_batch=per_batch, kernel_device_ms=kernel_ms, merge_device_ms=merge_ms,
            main_route_ms=main_ms, main_route_max_abs_err=main_err,
            main_route_splits=main_splits))

    # the sweep that set fk._SMALL_Q_F64: both float64 routes by q, called directly
    sweep = {}
    for q in SMALLQ_SWEEP:
        Qt = torch.as_tensor(rng.standard_normal((q, dim)), device=device)
        q2 = (Qt * Qt).sum(dim=1)
        s_sq = fk.smallq_splits(n, q, fk.smallq_wave(device, q, torch.float64),
                                fk._SQ_QBLOCK_F64)
        s_main = fk.auto_splits(n, q, SERVE_K, sms, torch.float64)
        sweep[q] = (
            cuda_ms(lambda: fk.merge_partials(*fk.fused_knn_smallq_f64(
                items64, valid64, Qt, SERVE_K, s_sq), q2, SERVE_K), reps=10),
            cuda_ms(lambda: main_route(Qt, q2, s_main), reps=10))
    log(f"  (hh) float64 routes by q at {n} x {dim}, k={SERVE_K}, ms small-q / main kernel "
        f"(fk._SMALL_Q_F64 = {fk._SMALL_Q_F64}): " + ", ".join(
            f"{q}: {a:.4f} / {b:.4f}" for q, (a, b) in sweep.items()) + f" [{card}]")
    cells.append({"cell": "(hh) float64 routes by q, ms small-q / main kernel",
                  "sweep": {str(q): list(t) for q, t in sweep.items()},
                  "small_q_f64": fk._SMALL_Q_F64})
    return entries, cells


def _scale_models(seed: int):
    from spark_rapids_ml_torch.classification import LogisticRegression
    from spark_rapids_ml_torch.feature import PCA
    from spark_rapids_ml_torch.knn import NearestNeighbors

    X, y = gen_binary(20_000, SERVE_SCALE_DIM, seed + 161)
    knn = NearestNeighbors(k=8).fit({"features": X[:2000]})

    def nn_transform(Q):
        dist, pos = knn._search(np.asarray(Q, np.float32), 8)
        return {"distances": dist, "indices": pos}

    return [(LogisticRegression(maxIter=10).fit((X, y)), None),
            (PCA(k=8).setInputCol("features").setOutputCol("proj").fit({"features": X}), None),
            (knn, nn_transform)]


def serve_ii(device, specs, seed: int, card: str) -> dict:
    """(ii): bench_serving_scale's 200 pinned models, 4:1 interactive:batch,
    the burst queued while paused (so both depths coalesce the same
    batches) and drained at depth 1 and at the auto depth."""
    from spark_rapids_ml_torch import config
    from spark_rapids_ml_torch.serving import ServingOverload, ServingServer
    from spark_rapids_ml_torch.telemetry import utilization

    rng = np.random.default_rng(seed + 162)
    reqs = [rng.standard_normal((1, SERVE_SCALE_DIM), dtype=np.float32)
            for _ in range(SERVE_SCALE_REQUESTS)]
    runs = {}
    for depth in (1, 0):
        config.set_config(serving_pipeline_depth=depth, serving_max_wait_ms=5.0,
                          serving_max_queue=4 * SERVE_SCALE_REQUESTS)
        server = ServingServer()
        for i in range(SERVE_SCALE_MODELS):
            m, fn = specs[i % len(specs)]
            server.register(f"m{i:03d}", m, n_features=SERVE_SCALE_DIM, transform=fn)
        server.start()
        try:
            for name in ("m000", "m001", "m002"):
                server.transform(name, reqs[0], timeout=300)
            _settled(server)
            b0 = server.pipeline_info()["batches"]
            utilization.clear()
            drops = 0
            server.pause()
            t0 = time.perf_counter()
            futs = []
            for j, r in enumerate(reqs):
                pr = "batch" if j % 5 == 4 else "interactive"
                try:
                    futs.append(server.submit(f"m{j % SERVE_SCALE_MODELS:03d}", r, priority=pr))
                except ServingOverload:
                    drops += pr == "interactive"
                    futs.append(None)
            t_submit = time.perf_counter() - t0
            t1 = time.perf_counter()
            server.resume()
            outs = [f.result(timeout=600) if f is not None else None for f in futs]
            t_end = time.perf_counter()
            _settled(server)
            rep = server.report()
            p99 = max(v.get("p99_ms", 0.0) for k, v in rep.items() if not k.startswith("_"))
            runs[depth] = {
                "cell": f"(ii) {SERVE_SCALE_MODELS} models, depth "
                        f"{'auto' if depth == 0 else depth}",
                "resolved_depth": server.pipeline_info()["depth"],
                "qps": SERVE_SCALE_REQUESTS / (t_end - t0),
                "drain_qps": SERVE_SCALE_REQUESTS / (t_end - t1), "submit_s": t_submit,
                "worst_p99_ms": p99, "interactive_drops": drops,
                "batches": server.pipeline_info()["batches"] - b0,
                "pinned_bytes": rep["_totals"]["pinned_bytes"], **_serving_util(),
                "outs": outs,
            }
        finally:
            server.stop()
            server.registry.clear()
            config.reset_config()
        r = runs[depth]
        log(f"  {r['cell']} (resolved {r['resolved_depth']}): {r['qps']:.1f} q/s aggregate "
            f"({r['drain_qps']:.1f} q/s draining), worst p99 {r['worst_p99_ms']} ms, "
            f"{r['batches']} batches, interactive drops {drops}, idle share "
            f"{r['idle_share']} [{card}]")
        if drops:
            raise AssertionError(f"{r['cell']}: {drops} interactive requests dropped")
    for a, b in zip(runs[1].pop("outs"), runs[0].pop("outs")):
        for col in a:
            if a[col].tobytes() != b[col].tobytes():
                raise AssertionError(f"(ii) depth 1 and the auto depth differ in {col}")
    runs[0]["pipeline_speedup_x"] = runs[0]["qps"] / runs[1]["qps"]
    log(f"  (ii) both depths byte-equal; auto over depth 1 "
        f"{runs[0]['pipeline_speedup_x']:.2f}x")
    return [runs[1], runs[0]]


def serve_jj(device, pca, seed: int, card: str) -> dict:
    """(jj): an injected serving_dispatch OOM and a serving_collect
    transient at depth 3, then bench_serving_control's brownout cut to fit
    the phase: every request answered once, batch shed before
    interactive."""
    from spark_rapids_ml_torch import config
    from spark_rapids_ml_torch.resilience import fault_inject
    from spark_rapids_ml_torch.resilience.retry import RETRIES
    from spark_rapids_ml_torch.serving import ServingOverload, ServingServer
    from spark_rapids_ml_torch.telemetry import utilization

    rng = np.random.default_rng(seed + 163)
    d = pca.components_.shape[1]
    config.set_config(serving_pipeline_depth=3, serving_max_batch_rows=8,
                      retry_backoff_s=0.01, retry_jitter=0.0, serving_max_queue=256,
                      serving_controller_interval_s=0.05, serving_brownout_sustain_s=0.2,
                      serving_brownout_recover_s=0.2)
    server = ServingServer()
    server.register("ctl", pca, n_features=d)
    server.start()
    try:
        server.transform("ctl", rng.standard_normal((1, d), dtype=np.float32), timeout=300)
        utilization.clear()
        reqs = [rng.standard_normal((1, d), dtype=np.float32) for _ in range(64)]
        answered = []
        server.pause()
        futs = [server.submit("ctl", r) for r in reqs]
        for f in futs:
            f.add_done_callback(lambda f: answered.append(f.request_id))
        r_oom = RETRIES.value(label="serving_dispatch", action="oom")
        r_tr = RETRIES.value(label="serving_dispatch", action="transient")
        t0 = time.perf_counter()
        with fault_inject("serving_dispatch", "oom", times=1), \
                fault_inject("serving_collect", "timeout", times=1):
            server.resume()
            outs = [f.result(timeout=120) for f in futs]
        fault_s = time.perf_counter() - t0
        want = pca._transform_array(np.concatenate(reqs))["proj"]
        got = np.concatenate([o["proj"] for o in outs])
        err = float(np.abs(got - want).max())
        retried = (RETRIES.value(label="serving_dispatch", action="oom") - r_oom,
                   RETRIES.value(label="serving_dispatch", action="transient") - r_tr)
        if (sorted(answered) != sorted(f.request_id for f in futs)
                or err > 1e-5 * max(1.0, float(np.abs(want).max())) or min(retried) < 1):
            raise AssertionError(f"(jj) faults: answered {len(answered)} of {len(futs)}, "
                                 f"err {err:.3e}, retries (oom, transient) {retried}")
        fault_util = _serving_util()
        log(f"  (jj) faults at depth 3: {len(futs)} requests answered once in {fault_s:.3f} s, "
            f"retries (oom, transient) {retried}, cap now {server._shrunk_cap}, max err "
            f"{err:.3e}, idle share {fault_util['idle_share']}")

        def phase() -> str:
            return server.report()["ctl"]["controller"]["brownout_phase"]

        utilization.clear()
        config.set_config(serving_slo_targets="ctl=0.0001")
        batch_total = batch_shed = inter_drops = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 10.0:
            pend = []
            for i in range(8):
                pr = "batch" if i % 2 else "interactive"
                try:
                    pend.append(server.submit("ctl", reqs[i], priority=pr))
                    batch_total += pr == "batch"
                except ServingOverload:
                    batch_total += pr == "batch"
                    batch_shed += pr == "batch"
                    inter_drops += pr == "interactive"
            for f in pend:
                f.result(timeout=60)
            if phase() != "normal" and batch_shed:
                break
        t_shed = time.perf_counter() - t0
        shed_phase = phase()
        config.set_config(serving_slo_targets="ctl=60000")
        t0 = time.perf_counter()
        recovery_s = None
        while time.perf_counter() - t0 < 10.0:
            server.transform("ctl", reqs[0], timeout=60)
            if phase() == "normal":
                recovery_s = time.perf_counter() - t0
                break
            time.sleep(0.02)
        brown_util = _serving_util()
        log(f"  (jj) brownout: {shed_phase} after {t_shed:.2f} s, batch shed "
            f"{batch_shed} of {batch_total}, interactive drops {inter_drops}, back to normal "
            f"in {recovery_s} s, idle share {brown_util['idle_share']} [{card}]")
        if not batch_shed or inter_drops or recovery_s is None:
            raise AssertionError("(jj) brownout: batch must shed before interactive, and "
                                 "the phase must recover")
    finally:
        server.stop()
        server.registry.clear()
        config.reset_config()
    return {"cell": "(jj) faults at depth 3 and the brownout", "requests": len(futs),
            "fault_s": fault_s, "retries_oom_transient": retried, "max_abs_err": err,
            "fault_idle_share": fault_util["idle_share"],
            "shed_fraction": batch_shed / max(batch_total, 1), "interactive_drops": inter_drops,
            "shed_after_s": t_shed, "recovery_s": recovery_s,
            "brownout_idle_share": brown_util["idle_share"]}


def phase_serving(device, args, knn_model, lr_X, lr_y, card: str) -> dict:
    """Phase 16: (hh), (ii), (jj)."""
    from spark_rapids_ml_torch import config

    config.reset_config()
    t_phase = time.perf_counter()
    hh, kernels = serve_hh(device, lr_X, lr_y, knn_model, args.seed, card)
    log(f"  (hh) done at {time.perf_counter() - t_phase:.1f} s")
    specs = _scale_models(args.seed)
    ii = serve_ii(device, specs, args.seed, card)
    log(f"  (ii) done at {time.perf_counter() - t_phase:.1f} s")
    jj = serve_jj(device, specs[1][0], args.seed, card)
    log(f"  phase 16 {time.perf_counter() - t_phase:.1f} s")
    return {"cells": hh + ii + [jj], "kernels": kernels}


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
    # the float64 small-q kernel keeps its 32 double accumulators in
    # registers: no instance may touch local memory
    local = {name: c["LDL"] + c["STL"] for name, c in counts.items()
             if name.startswith("fused_knn_smallq_f64_kernel")}
    if len(local) != 6 or any(local.values()):
        raise AssertionError(f"fused_knn_smallq_f64_kernel: instances and their LDL + STL "
                             f"{local} (six instances, none with local memory)")


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
    ap.add_argument("--k-dbscan-rows", type=int, default=10_000)
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
    # phase 5's rows, made on a host thread beside phases 1-4 (the build
    # runs nvcc in other processes)
    logistic_rows = start_logistic_rows(args)
    phase_build(args)
    hold_trace_read()

    stage("phase 2: kernels vs their plain versions on the card")
    phase_kernels_vs_plain(device, args.seed)

    stage(f"phase 3: main path, {args.items} x {args.dim} items, {args.queries} queries, "
          f"k={args.k}")
    main_out = phase_main_path(device, args)

    stage("phase 4: float64 path, a fifth of the items and queries; then the main shape")
    f64 = phase_float64_path(device, args)

    stage(f"phase 5: LogisticRegression: (a) bench.py's headline, (b) the reference benchmark's "
        "width, (c) softmax + OWL-QN + weights in float64")
    logistic = phase_logistic(device, args, logistic_rows)
    del logistic_rows

    stage(f"phase 6: PCA and LinearRegression: (d) PCA k=3 at bench.py's 1M x 128, (e) PCA k=3 "
        "and (f) LinearRegression at the reference benchmark's 1M x 3000, (g) float64 with "
        "weights, card against CPU")
    pca_linear = phase_pca_linear(device, args, logistic.pop("X_wide"))

    stage("phase 7: persistence")
    phase_persistence(main_out, logistic, pca_linear)

    import shutil

    wide_X, wide_y = pca_linear.pop("X_f"), logistic.pop("y_wide")
    p_X, p_y = wide_X[:PARQUET_ROWS], wide_y[:PARQUET_ROWS]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_parquet_")
    # phase 10's 6 GB file, written on a host thread beside phases 8 and 9
    # (which only read the rows)
    parquet_path = os.path.join(tmp, "ref_1m_3k.parquet")
    parquet_written = start_reference_parquet(parquet_path, p_X, p_y)
    try:
        stage(f"phase 8: KMeans and DBSCAN: (h) KMeans k=20 at BASELINE.json's 100M x 64, (i) "
              "the reference benchmark's kmeans_k1000_iter30 at 1M x 3000, (j) DBSCAN on "
              "bench.py's 300k x 16 blobs, (k) float64, card against CPU")
        clustering = phase_clustering(device, args, wide_X)

        stage("phase 9: RandomForest: (l) the reference benchmark's "
              "random_forest_classifier_50t_d13 and (m) random_forest_regressor_30t_d6 at 1M x "
              f"3000, (n) BASELINE.json's classifier at {RF_N_ROWS} x 64 ({RF_N_TREES} trees), "
              "(o) float64, card against CPU")
        forest = phase_forest(device, args, wide_X, wide_y)

        stage(f"phase 10: parquet: (p) {PARQUET_ROWS} rows of the reference benchmark's "
              "1M x 3000 input as parquet through the fused and staged routes, (q) the "
              "streamed route on it, (r) bench.py's 2M x 64 epoch-streaming cell")
        parquet = phase_parquet(device, args, p_X, p_y, tmp, parquet_written)
        stage("phase 11: chunk cache and stats: (s) bench.py's epoch-cache cell, (t) DuHL on "
              "(r)'s file, (u) summarize: bench.py's cell and (p)'s file")
        cache_stats = phase_cache_stats(device, tmp, parquet["paths"], p_X.shape[0],
                                        args.r_rows, p_X)
    finally:
        parquet_written.exception()  # the writer has stopped before its directory goes
        shutil.rmtree(tmp, ignore_errors=True)
    del p_X, p_y
    stage("phase 12: the meta layer: (v) bench.py's cv_cached cell, (w) CrossValidator, "
          "fitMultiple and evaluate at the reference benchmark's width")
    meta = phase_meta(device, args, wide_X, wide_y)
    serve_X, serve_y = wide_X[:SERVE_LR_ROWS].copy(), wide_y[:SERVE_LR_ROWS].copy()
    del wide_X, wide_y

    stage("phase 13: ApproximateNearestNeighbors: (x) IVF-Flat and IVF-PQ at BASELINE.json's "
          "10M x 128, (y) CAGRA at 1M x 128 and bench.py's 200k x 64 ANN cell, (z) checks")
    ann = phase_ann(device, args)

    stage("phase 14: UMAP: (aa) BASELINE.json's configs[4] on a tenth of (x)'s 10M x 128 rows, "
          "(bb) bench.py's bench_umap cells, (cc) the fused kernel on UMAP's path, (dd) checks")
    umap = phase_umap(device, args, ann.pop("X"))

    stage(f"phase 15: sparse LogisticRegression and resilience: (ee) {SPARSE_ROWS} x "
          f"{SPARSE_COLS} Criteo-layout rows through the ELL route, (ff) 5 classes on "
          f"{SPARSE_SUB_ROWS} rows, (gg) resume, a real OOM, the watchdog, a sticky error, "
          "KMeans resume")
    sparse = phase_sparse_resilience(device, args, card)

    stage(f"phase 16: serving: (hh) bench_serving at full width ({SERVE_LR_ROWS} x 3000 "
          f"LogisticRegression, PCA k=3 and kNN k={SERVE_K} over phase 3's items), (ii) "
          f"{SERVE_SCALE_MODELS} pinned models at depth 1 and auto, (jj) faults at depth 3 "
          "and the brownout")
    serving = phase_serving(device, args, main_out["model"], serve_X, serve_y, card)
    del serve_X, serve_y

    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"logistic": logistic["cells"]}))
    print(json.dumps({"pca_linear": pca_linear["cells"]}))
    print(json.dumps({"clustering": clustering["cells"]}))
    print(json.dumps({"forest": forest["cells"]}))
    print(json.dumps({"parquet": parquet["cells"]}, default=float))
    print(json.dumps({"cache_stats": cache_stats["cells"]}, default=float))
    print(json.dumps({"meta": meta["cells"]}, default=float))
    print(json.dumps({"ann": ann["cells"]}, default=float))
    print(json.dumps({"umap": umap["cells"]}, default=float))
    print(json.dumps({"sparse": sparse["cells"]}, default=float))
    print(json.dumps({"serving": serving["cells"]}, default=float))
    print(json.dumps({"kernels": main_out["kernels"] + f64 + [ann["kernel"]] + umap["kernels"]
                      + serving["kernels"]}, default=float))
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
