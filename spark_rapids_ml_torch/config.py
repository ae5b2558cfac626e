#
# Global configuration — the port of spark_rapids_ml_tpu/config.py for the
# core keys and the keys the exact-kNN, LogisticRegression, PCA,
# LinearRegression, clustering, parquet/streaming, chunk-cache, statistics
# and meta-layer slices read.
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
    # Per-iteration checkpoints of the streamed fits: not ported; a
    # non-empty value raises NotImplementedError (ROADMAP.md section 1).
    "streaming_checkpoint_dir": "",
}

# Keys whose default is None, and the type an environment value takes.
_TYPES: Dict[str, type] = {"hbm_bytes": int, "num_workers": int}

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
