#
# Global configuration — the port of spark_rapids_ml_tpu/config.py for the
# core keys and the keys the exact-kNN, LogisticRegression, PCA,
# LinearRegression, clustering, parquet/streaming, chunk-cache, statistics,
# meta-layer, UMAP, resilience, tracing/telemetry and serving slices read.
# The confs live in a process-global dict, overridable from the
# environment (`SPARK_RAPIDS_ML_TORCH_<KEY>`) or `set_config()`.  Key
# names and defaults match the JAX package, except where a comment says
# otherwise; later slices add their keys here.
#
# The compute device is NOT a conf key: it is chosen through
# `spark_rapids_ml_torch.set_default_device` (parallel/context.py).
#
import os
import threading
from typing import Any, Dict, Optional

_lock = threading.Lock()

_DEFAULTS: Dict[str, Any] = {
    # The four core keys of the JAX package.  float32_inputs: cast float64
    # inputs to float32 on the device (read when an estimator is built,
    # params.py).  num_workers: the devices a fit runs on; None is one
    # device here (the JAX package counts its visible devices), and a value
    # above 1 raises at fit until the multi-GPU item (8) of ROADMAP.md.
    # cpu_fallback_enabled: fit with scikit-learn when an unsupported param
    # is set; not ported (the card's machine has no scikit-learn), so such
    # a fit raises NotImplementedError (core.py).  verbose: the logging
    # level 0-6, accepted and read by nothing.
    "float32_inputs": True,
    "num_workers": None,
    "cpu_fallback_enabled": False,
    "verbose": 0,
    # Hand-written fused distance + top-k kernel for exact kNN
    # (ops/fused_knn.py, the port of the Pallas kernel).  The JAX package
    # defaults to "off" because its Pallas kernel lost to XLA on a TPU;
    # the port defaults to "on", so on the card the CUDA kernel IS the kNN
    # path.  "auto" means "on" (no measured probe is ported); "off" is an
    # explicit choice of the plain torch path (ops/knn.py
    # knn_topk_blocked / knn_topk_coltiled).
    "pallas_knn": "on",
    # Matmul precision of the plain torch distance forms (ops/precision.py):
    # "highest" = IEEE f32 (TF32 off), the default; see that module for
    # the mapping of "high" and "default".
    "distance_precision": "highest",
    # Host staging budget in bytes: rows per chunk of the chunked
    # transform (core.py `_TpuModel._transform_mesh`) and of a streamed
    # parquet pass (streaming.py `chunk_rows_for`).
    "host_batch_bytes": 512 * 1024 * 1024,
    # The JAX package's per-program operation budget.  LogisticRegression
    # does not read it (the port always runs the host-driven solver,
    # ops/logistic.py `logreg_fit_host_dispatch`); KMeans reads it for the
    # JAX package's gate (ops/kmeans.py `kmeans_fit_auto`), which decides
    # whether seeding sees every row or a strided subsample.
    "dispatch_flops_limit": 2e12,
    # bfloat16 feature storage for the L-BFGS matvecs.  Not ported yet:
    # True raises NotImplementedError (models/classification.py).
    "bf16_features": False,
    # Host bytes of one chunk of the fused stage-and-solve pass
    # (fused.py `fused_chunk_rows`): the unit of host prep and of the
    # host-to-device copy the device accumulates.
    "staging_chunk_bytes": 256 * 1024 * 1024,
    # How many prepared chunks (cast, padded, in pinned host buffers) the
    # fused pass's producer thread may run ahead of the device; 1 = no
    # thread.  Each level costs one chunk of pinned host memory.
    "staging_pipeline_depth": 2,
    # Precision of the sufficient-statistics products (PCA covariance,
    # the LinearRegression Gram): ops/precision.py `stats_precision`.
    # "highest" and "high" = IEEE float32 (TF32 off), "high_compensated"
    # adds Kahan carries to the chunk accumulators, "default" = TF32.
    "stats_precision": "highest",
    # Fused stage-and-solve for PCA and LinearRegression fits from host
    # arrays (fused.py): "auto" fuses once the staged bytes reach
    # fused.py `_AUTO_MIN_BYTES`, "on" always, "off" never.  A
    # DeviceDataset and CSR input always take the two-phase path.
    "fused_stage_solve": "auto",
    # PCA eigensolver (ops/pca.py `resolve_pca_solver`): "full" (the d x d
    # covariance + eigh), "randomized" (the Halko range-finder, l = k +
    # pca_oversamples columns), or "auto".
    "pca_solver": "auto",
    "pca_oversamples": 10,
    # Power (subspace) iterations of the randomized range-finder.
    "pca_power_iters": 2,
    # Fit a parquet path without reading it whole into host memory
    # (core.py `_stage_or_stream`): the fused pass from parquet, the
    # stream-staged DeviceDataset, or the streamed fits.  False reads the
    # file whole, as any other dataset.
    "streaming_ingest": True,
    # Take the streamed fits (streaming.py) whatever the device budget.
    "force_streaming_stats": False,
    # The share of the device's memory a staged dataset may take
    # (core.py `_over_device_budget`).
    "mem_ratio_for_data": 0.8,
    # The device's memory in bytes for that budget.  The JAX package's
    # default, 16 GiB, is a TPU v5e's HBM; in the port None means: the
    # card's own memory (`torch.cuda.get_device_properties`) on a card,
    # the JAX package's 16 GiB on the CPU, so that routing on the CPU
    # matches it.  A set value overrides both.
    "hbm_bytes": None,
    # Decode parquet chunks on a background thread ahead of the device
    # (streaming.py `iter_chunks_prefetch`), up to `streaming_prefetch_depth`
    # chunks ahead; each level costs one chunk of host memory; 1 = no
    # thread.
    "streaming_prefetch": True,
    "streaming_prefetch_depth": 3,
    # Parallel parquet range readers of the fused pass and of the staging
    # (fused.py `resolve_parquet_readers`): "auto" (the host's cores, at
    # most 16) or a pinned count.
    "fused_parquet_readers": "auto",
    # The chunk cache (parallel/device_cache.py `ChunkCache`): "on" records
    # the decoded chunks of a parquet scan the first time it runs and
    # replays them for every later identical scan.  A replayed feature
    # block lives on the card while the device-budget ledger has free room,
    # else in pinned host memory under `chunk_cache_host_bytes`, and beyond
    # that in the spill tier (`chunk_cache_codec`, crc32-checked).  "off"
    # decodes every scan.
    "chunk_cache": "on",
    # Host bytes of the cache's host and in-memory spill tiers; LRU chunks
    # spill, then LRU streams are dropped, beyond it.
    "chunk_cache_host_bytes": 1024 * 1024 * 1024,
    # Spill codec (parallel/chunk_codec.py): "none", "zlib", or "lz4" /
    # "zstd" where their wheels are installed; custom codecs register with
    # `chunk_codec.register_codec`.
    "chunk_cache_codec": "none",
    # A directory for spilled chunks (files, outside the host budget);
    # empty keeps spilled blobs in host memory.
    "chunk_cache_spill_dir": "",
    # DuHL chunk sampling of the streamed LogisticRegression and KMeans
    # (streaming.py `DuhlChunkSampler`): "duhl" lets an epoch revisit only
    # the chunks whose contribution still moves, once the chunk cache holds
    # the whole stream; "off" runs exact full passes.
    "streaming_chunk_sampling": "off",
    # The share of the cached chunks a sampled epoch revisits, clamped to
    # [0.1, 1].
    "streaming_chunk_sample_fraction": 0.5,
    # Sketch sizes of the statistic programs (stats/): the quantile
    # sketch's items per level, the frequent-items table per column, the
    # HyperLogLog precision bits, and the chi-squared contingency bins.
    "summarizer_sketch_k": 256,
    "summarizer_frequent_k": 64,
    "summarizer_hll_bits": 12,
    "summarizer_chi2_bins": 16,
    # Bytes of the device-budget ledger (parallel/device_cache.py
    # `cache_budget_bytes`); 0: `device_data_budget_bytes`, the staging
    # decisions' own budget.
    "device_cache_bytes": 0,
    # The stage-once dataset cache of CrossValidator
    # (parallel/device_cache.py `get_or_stage`): "on" stages a CV run's
    # dataset once and derives every fold's train and eval rows on the
    # device; "off" restages each fold from the host (the legacy path).
    "device_cache": "on",
    # UMAP's SGD epoch (ops/umap.py `optimize_embedding`): "structured"
    # (the head-major form: sums over k and one sorted segment sum, no
    # atomics), "generic" (`index_add_` scatters), or "auto": a measured
    # probe of both, or, where a fit sets random_state or runs fewer than
    # 10 epochs, the prior: structured on a card (the form whose fits
    # repeat bit for bit), generic on the CPU.
    "umap_kernel": "auto",
    # The resilience layer (resilience/), with the JAX package's keys and
    # defaults.  streaming_checkpoint_dir: the streamed fits' checkpoint
    # directory, an older alias of checkpoint_dir for them alone.
    # checkpoint_dir: every iterative fit (the host L-BFGS/OWL-QN, FISTA,
    # the stepwise KMeans, the streamed fits) saves its solver state there
    # after each iteration and resumes from it after a crash; empty is off.
    "streaming_checkpoint_dir": "",
    "checkpoint_dir": "",
    # Watchdog deadline in seconds of a guarded fit or dispatch
    # (resilience/guard.py); 0 runs it inline with no watchdog thread.
    "dispatch_deadline_s": 0.0,
    # The retry policy (resilience/retry.py `RetryPolicy.from_config`):
    # attempts in all, and the backoff's base, multiplier and jitter.
    "retry_max_attempts": 3,
    "retry_backoff_s": 0.5,
    "retry_backoff_mult": 2.0,
    "retry_jitter": 0.25,
    # Deterministic fault injection (resilience/faults.py):
    # "site:kind[:times[:skip]]" comma list, e.g.
    # "fit_kernel:oom:1,transform_dispatch:timeout:1:2"; empty disables.
    "fault_inject_spec": "",
    # Elastic device-loss recovery (resilience/elastic.py).  The JAX
    # package shrinks its mesh to the surviving devices ("on"), down to
    # `elastic_min_devices`, else takes the full retry.  One card has no
    # survivors, so every value gives the full retry: accepted, no result
    # changes.
    "elastic": "on",
    "elastic_min_devices": 1,
    # Pad a transform's staged chunks to the {1, 1.5} x 2^k row-bucket grid
    # (parallel/mesh.py `bucket_rows`, min 256) and align its full chunks
    # to the grid (core.py `_transform_mesh`).  The padding rows are zeros
    # and never returned.  On a card it gives every padding class one
    # product shape, so a row's result does not depend on how many rows
    # share its chunk.  Fits stage exact shapes whatever its value.
    "shape_bucketing": True,
    # Stage small arrays (below 4 MiB) with one copy from a reused pinned
    # host buffer and one direct host-to-device copy, without the chunk
    # loop (parallel/mesh.py `RowStager._stage_small_direct`); the same
    # bytes either way.  The serving layer's micro-batches live on it.
    "staging_small_direct": True,
    # When set, `tracing.device_profile` regions run under torch.profiler
    # and write a Chrome trace into this directory.
    "profile_dir": None,
    # Named-lock contention profiling (telemetry/locks.py): a blocked
    # acquire that waited at least this many milliseconds drops a
    # `lock_slow_wait[<name>]` instant marker into the active run's span
    # tree (the cumulative wait/hold counters record regardless).  <= 0
    # disables the markers.
    "lock_slow_wait_ms": 50.0,
    # The serving layer (serving/), with the JAX package's keys and
    # defaults.  serving_max_batch_rows: hard cap on the rows one coalesced
    # dispatch may carry; the effective cap is min(this,
    # host_batch_bytes / row bytes), halved further after an OOM (floor:
    # one row).
    "serving_max_batch_rows": 4096,
    # Longest a queued request waits for co-batchable traffic before its
    # batch dispatches anyway (milliseconds).
    "serving_max_wait_ms": 2.0,
    # Admission control: requests beyond this many queued across all
    # models are rejected with a typed ServingOverload.
    "serving_max_queue": 1024,
    # The HTTP JSON endpoint (serving/http.py) on this loopback port when
    # a server starts; 0 = off.
    "serving_port": 0,
    # A request whose total latency reaches this many milliseconds has its
    # batch's span tree captured (`ServingServer.slow_traces()`); <= 0 off.
    "serving_slow_trace_ms": 0.0,
    # Declared p99 latency target (milliseconds) of every served model, read
    # by the `slo_burn_rate{model,window}` gauges; <= 0 disables them.
    # `serving_slo_targets` ("model=ms,model2=ms") overrides it per model.
    "serving_slo_p99_ms": 0.0,
    "serving_slo_targets": "",
    # The closed-loop controller (serving/control.py): "on" runs the
    # per-model AIMD feedback on the coalescing cap and max-wait,
    # priority-class admission and the brownout phase machine; "off" keeps
    # the static knobs.  Its interval (seconds), burn high and low waters,
    # the batch class's queue/dispatch share, and the default class.
    "serving_controller": "on",
    "serving_controller_interval_s": 1.0,
    "serving_controller_burn_high": 1.0,
    "serving_controller_burn_low": 0.5,
    "serving_batch_share": 0.25,
    "serving_priority_default": "interactive",
    # Brownout: a 1m burn at or above `serving_brownout_burn` held for
    # `serving_brownout_sustain_s` escalates one phase (normal ->
    # shed_batch -> shed_interactive); a burn at or below the low water
    # held for `serving_brownout_recover_s` de-escalates one.
    "serving_brownout_burn": 2.0,
    "serving_brownout_sustain_s": 5.0,
    "serving_brownout_recover_s": 5.0,
    # Pad coalesced micro-batches to the row-bucket grid whatever
    # `shape_bucketing` says: every padding class computes with one
    # product shape.
    "serving_padding_buckets": True,
    # Staged dispatch pipeline (serving/server.py): how many coalesced
    # batches may be in flight at once (1 = fully serialized, the
    # byte-parity baseline); 0 = auto from the serving idle-gap profile,
    # at most `serving_pipeline_max_depth`.  Each in-flight batch has its
    # own CUDA stream on a card.
    "serving_pipeline_depth": 0,
    "serving_pipeline_max_depth": 4,
    # Rotate which model's due batch dispatches within a priority class
    # (FIFO within each model's class either way).
    "serving_pipeline_interleave": True,
}

# Keys whose default is None, and the type an environment value takes.
_TYPES: Dict[str, type] = {"hbm_bytes": int, "num_workers": int, "profile_dir": str}

_ENV_PREFIX = "SPARK_RAPIDS_ML_TORCH_"

_config: Dict[str, Any] = {}


def _coerce(key: str, raw: str) -> Any:
    ty = _TYPES.get(key, type(_DEFAULTS[key]))
    if ty is bool:
        return raw.lower() in ("1", "true", "yes", "on")
    if ty is int:
        return int(raw)
    if ty is float:
        return float(raw)
    return raw


def _effective_locked(key: str, default: Optional[Any] = None) -> Any:
    """Effective (env-aware) value; caller must hold _lock (non-reentrant)."""
    if key in _config:
        return _config[key]
    env = os.environ.get(_ENV_PREFIX + key.upper())
    if env is not None and key in _DEFAULTS:
        return _coerce(key, env)
    return _DEFAULTS.get(key, default)


def get_config(key: str, default: Optional[Any] = None) -> Any:
    if key not in _DEFAULTS and default is None:
        raise KeyError(f"Unknown config key: {key}")
    with _lock:
        return _effective_locked(key, default)


def set_config(**kwargs: Any) -> None:
    with _lock:
        for k in kwargs:
            if k not in _DEFAULTS:
                raise KeyError(f"Unknown config key: {k}")
        _config.update(kwargs)


def reset_config() -> None:
    with _lock:
        _config.clear()
