#
# UMAP: the port of spark_rapids_ml_tpu/models/umap.py, on one device.
#
# The fit runs on one device as the reference fits on one worker
# (optionally on a `sample_fraction` of the rows): the kNN graph (brute
# force through `umap_knn_graph`, whose euclidean branch is the fused
# kernel on the card, or NN-descent, ops/cagra.py), the fuzzy simplicial
# set and the SGD epochs of ops/umap.py.  The model keeps the embedding
# and the raw training rows (dense or CSR); a transform finds each new
# row's neighbours among them and places it at the membership-weighted
# mean of their embeddings.  Saved as the JAX package saves it
# (`metadata.json` + `arrays.npz`, CSR rows as `__csr_*` parts): either
# package loads the other's.  `num_workers > 1` raises (ROADMAP.md item
# 8).
#
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Union

import numpy as np

from ..core import _TpuEstimator, _TpuModel
from ..data import DatasetLike, _ensure_dense, _is_sparse
from ..params import (
    HasFeaturesCol,
    HasFeaturesCols,
    HasLabelCol,
    HasOutputCol,
    Param,
    TypeConverters,
    _TpuParams,
)

# Host seconds of the last fit by part, each part ending in a device sync
# ("sample", "stage", "knn_graph", "smooth_knn_dist", "fuzzy_set",
# "supervised", "find_ab_params", "init", "sgd"), with "n_rows",
# "n_epochs" and "graph" ("brute_force_knn" or "nn_descent").
LAST_FIT: dict = {}


class UMAPClass:
    """Param surface (cuML's names: there is no Spark UMAP, so the mapping
    is the identity)."""

    @classmethod
    def _param_mapping(cls) -> Dict[str, Optional[str]]:
        return {
            n: n
            for n in (
                "n_neighbors", "n_components", "metric", "metric_kwds",
                "n_epochs",
                "learning_rate", "init", "min_dist", "spread",
                "set_op_mix_ratio", "local_connectivity",
                "repulsion_strength", "negative_sample_rate", "a", "b",
                "random_state", "sample_fraction", "target_metric",
                "target_weight", "build_algo", "build_kwds",
            )
        }

    @classmethod
    def _param_value_mapping(cls):
        from ..ops.distances import SUPPORTED_METRICS

        return {
            "metric": lambda x: x if x in SUPPORTED_METRICS else None,
            "init": lambda x: x if x in ("spectral", "random") else None,
            "build_algo": lambda x: x
            if x in ("auto", "brute_force_knn", "nn_descent")
            else None,
        }

    @classmethod
    def _get_tpu_params_default(cls) -> Dict[str, Any]:
        return {
            "n_neighbors": 15,
            "n_components": 2,
            "metric": "euclidean",
            "metric_kwds": None,
            "n_epochs": None,
            "learning_rate": 1.0,
            "init": "spectral",
            "min_dist": 0.1,
            "spread": 1.0,
            "set_op_mix_ratio": 1.0,
            "local_connectivity": 1.0,
            "repulsion_strength": 1.0,
            "negative_sample_rate": 5,
            "transform_queue_size": 4.0,
            "a": None,
            "b": None,
            "precomputed_knn": None,
            "random_state": None,
            "sample_fraction": 1.0,
            "target_metric": "categorical",
            "target_weight": 0.5,
            "build_algo": "auto",
            "build_kwds": None,
            "verbose": False,
        }


class _UMAPParams(
    _TpuParams, HasFeaturesCol, HasFeaturesCols, HasLabelCol, HasOutputCol
):
    n_neighbors = Param("_", "n_neighbors", "Neighborhood size.",
                        TypeConverters.toFloat)
    n_components = Param("_", "n_components", "Embedding dimension.",
                         TypeConverters.toInt)
    metric = Param("_", "metric", "Distance metric.", TypeConverters.toString)
    metric_kwds = Param("_", "metric_kwds",
                        "Metric arguments (e.g. {'p': 3} for minkowski).",
                        TypeConverters.identity)
    n_epochs = Param("_", "n_epochs", "Training epochs (None = auto).",
                     TypeConverters.identity)
    learning_rate = Param("_", "learning_rate", "Initial learning rate.",
                          TypeConverters.toFloat)
    init = Param("_", "init", "Embedding init: spectral or random.",
                 TypeConverters.toString)
    min_dist = Param("_", "min_dist", "Minimum embedded distance.",
                     TypeConverters.toFloat)
    spread = Param("_", "spread", "Embedded scale.", TypeConverters.toFloat)
    set_op_mix_ratio = Param("_", "set_op_mix_ratio",
                             "Fuzzy union/intersection mix in [0,1].",
                             TypeConverters.toFloat)
    local_connectivity = Param("_", "local_connectivity",
                               "Assumed local connectivity.",
                               TypeConverters.toFloat)
    repulsion_strength = Param("_", "repulsion_strength",
                               "Negative-sample weighting.",
                               TypeConverters.toFloat)
    negative_sample_rate = Param("_", "negative_sample_rate",
                                 "Negative samples per positive edge.",
                                 TypeConverters.toInt)
    sample_fraction = Param("_", "sample_fraction",
                            "Fraction of rows used for the one-device fit.",
                            TypeConverters.toFloat)
    random_state = Param("_", "random_state", "Random seed.",
                         TypeConverters.identity)
    build_algo = Param(
        "_", "build_algo",
        "kNN graph build: 'auto' (brute force <= 50k rows, else "
        "nn_descent), 'brute_force_knn', or 'nn_descent'.",
        TypeConverters.toString)
    build_kwds = Param(
        "_", "build_kwds",
        "nn_descent arguments: nnd_graph_degree, nnd_max_iterations.",
        TypeConverters.identity)

    def __init__(self) -> None:
        super().__init__()
        self._setDefault(
            n_neighbors=15.0,
            n_components=2,
            metric="euclidean",
            n_epochs=None,
            learning_rate=1.0,
            init="spectral",
            min_dist=0.1,
            spread=1.0,
            set_op_mix_ratio=1.0,
            local_connectivity=1.0,
            repulsion_strength=1.0,
            negative_sample_rate=5,
            sample_fraction=1.0,
            random_state=None,
            build_algo="auto",
            outputCol="embedding",
        )

    def setFeaturesCol(self, value: Union[str, List[str]]):
        if isinstance(value, str):
            self._set_params(featuresCol=value)
        else:
            self._set_params(featuresCols=value)
        return self

    def setFeaturesCols(self, value: List[str]):
        return self._set_params(featuresCols=value)

    def setLabelCol(self, value: str):
        self._set(labelCol=value)
        return self

    def setOutputCol(self, value: str):
        self._set(outputCol=value)
        return self


# spectral init of CSR rows builds a d x d Gram; past this many columns its
# eigh would dominate the fit, so the fit takes the random init
_SPARSE_SPECTRAL_MAX_D = 4096


def _sparse_pca_basis_project(X, n_comp: int, dtype, device) -> np.ndarray:
    """The spectral init's PCA projection of CSR rows: the d x d float32
    Gram accumulated on the device over dense row chunks of
    `host_batch_bytes`, the covariance's eigh on the host in float64, then
    the chunks projected on the host.  Host peak memory: one dense chunk
    and the Gram."""
    import torch

    from ..ops.precision import ieee_matmul
    from ..streaming import chunk_rows_for

    n, d = X.shape
    # float64 projection chunks: rows by 8-byte items
    chunk = max(1, int(chunk_rows_for(d, 8)))
    mean = np.asarray(X.mean(axis=0)).ravel().astype(np.float64)
    G = torch.zeros((d, d), dtype=torch.float32, device=device)
    with ieee_matmul():
        for lo in range(0, n, chunk):
            hi = min(lo + chunk, n)
            c = torch.from_numpy(X[lo:hi].toarray().astype(np.float32)).to(device)
            G += c.T @ c
    cov = G.cpu().numpy().astype(np.float64) / n - np.outer(mean, mean)
    _, v = np.linalg.eigh(cov)
    V = v[:, ::-1][:, :n_comp]  # top components, descending eigenvalue
    pc = np.empty((n, n_comp), np.float64)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        pc[lo:hi] = (X[lo:hi].toarray().astype(np.float64) - mean) @ V
    return pc.astype(dtype)


class _PartTimer:
    """Seconds of each part of a fit into LAST_FIT, each part ended by a
    device sync."""

    def __init__(self, device) -> None:
        self.device = device
        LAST_FIT.clear()
        self.t = time.perf_counter()

    def done(self, part: str) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        LAST_FIT[part] = LAST_FIT.get(part, 0.0) + now - self.t
        self.t = now


class UMAP(UMAPClass, _TpuEstimator, _UMAPParams):
    """Uniform Manifold Approximation and Projection on one device.

    The fit runs the kNN graph (brute force, on the card the fused kernel,
    or NN-descent past 50,000 rows), the fuzzy simplicial set with the
    smooth-kNN bisection, and umap-learn's SGD over all edges each epoch
    (ops/umap.py).  `init="spectral"` uses a scaled PCA basis.

    Examples
    --------
    >>> import numpy as np
    >>> from spark_rapids_ml_torch import set_default_device
    >>> from spark_rapids_ml_torch.umap import UMAP
    >>> set_default_device("cpu")
    >>> X = np.random.default_rng(0).normal(size=(200, 8)).astype("float32")
    >>> m = UMAP(n_neighbors=10, random_state=1, n_epochs=50).fit(X)
    >>> m.embedding_.shape
    (200, 2)
    """

    def __init__(self, **kwargs: Any) -> None:
        super().__init__()
        self._set_params(**kwargs)

    def _is_supervised(self) -> bool:
        # supervised UMAP: labels flow into the fuzzy-set intersection when
        # the user sets labelCol
        return self.hasParam("labelCol") and self.isSet("labelCol")

    def _fit(self, dataset: DatasetLike) -> "UMAPModel":
        import torch

        from ..ops import umap as umap_ops
        from ..ops.distances import finalize_sqdist, metric_kind, preprocess_rows, umap_knn_graph
        from ..parallel.mesh import RowStager

        t0 = time.time()
        device = self._device()  # one device; num_workers > 1 raises
        timer = _PartTimer(device)
        batch = self._extract(dataset)
        sparse_in = _is_sparse(batch.X)
        if sparse_in:
            # CSR rows stay CSR on the host; the device matrix is assembled
            # chunk by chunk (RowStager.stage_sparse)
            X = batch.X.tocsr()
            dtype = self._out_dtype(X)
        else:
            X = _ensure_dense(batch.X)
            dtype = self._out_dtype(X)
            X = np.ascontiguousarray(X, dtype=dtype)
        p = self._tpu_params
        rs = p.get("random_state")
        seed = int(rs) if rs is not None else 42
        y_all = np.asarray(batch.y, np.float64) if batch.y is not None else None
        frac = float(p.get("sample_fraction", 1.0))
        if frac < 1.0:
            rng = np.random.default_rng(seed)
            keep = rng.random(X.shape[0]) < frac
            X_fit = X[keep]
            y_fit = y_all[keep] if y_all is not None else None
        else:
            X_fit, y_fit = X, y_all
        n, d = X_fit.shape
        k = int(float(p["n_neighbors"]))
        if k >= n:
            raise ValueError(f"n_neighbors={k} must be < n_samples={n}")
        metric = str(p.get("metric", "euclidean"))
        pw = float(dict(p.get("metric_kwds") or {}).get("p", 2.0))
        X_graph, row_tf = X_fit, None
        if metric_kind(metric) == "matmul":
            # cosine, correlation and hellinger as euclidean distance of
            # transformed rows (identity for the euclidean family); CSR rows
            # are transformed chunk by chunk as they are staged
            if sparse_in:
                row_tf = lambda c: preprocess_rows(c, metric)  # noqa: E731
            else:
                X_graph = np.asarray(preprocess_rows(X_fit, metric), dtype=dtype)
        timer.done("sample")

        # 1. kNN graph, self excluded: brute force for small n, NN-descent
        # past 50k rows
        build_algo = str(p.get("build_algo") or "auto")
        bk = dict(p.get("build_kwds") or {})
        use_nnd = build_algo == "nn_descent" or (build_algo == "auto" and n > 50_000)
        if use_nnd and metric_kind(metric) != "matmul":
            # NN-descent scores with the euclidean identity; elementwise
            # metrics keep the brute force
            self.logger.warning(
                f"build_algo={build_algo!r} resolved to nn_descent, which "
                f"does not support metric={metric!r}; using "
                "brute_force_knn (O(n²) at this row count)"
            )
            use_nnd = False
        st = RowStager(n, device)
        Xd = (st.stage_sparse(X_graph, dtype, row_transform=row_tf) if sparse_in
              else st.stage(X_graph, dtype))
        timer.done("stage")
        if use_nnd:
            from ..ops.cagra import knn_graph_nn_descent

            d2k, knn_i = knn_graph_nn_descent(
                Xd,
                k=k,
                deg=int(bk["nnd_graph_degree"]) if "nnd_graph_degree" in bk else None,
                rounds=int(bk.get("nnd_max_iterations", 8)),
                seed=0 if rs is None else int(rs),
            )
            knn_d = finalize_sqdist(d2k, metric)
        else:
            dists, inds = umap_knn_graph(Xd, st.mask(dtype), st.row_ids(), Xd, k=k + 1,
                                         metric=metric, p=pw)
            knn_d, knn_i = dists[:, 1:].contiguous(), inds[:, 1:].contiguous()
        knn_i = knn_i.long()
        del Xd
        LAST_FIT["graph"] = "nn_descent" if use_nnd else "brute_force_knn"
        timer.done("knn_graph")

        # 2. fuzzy simplicial set
        lc = max(1, int(float(p["local_connectivity"])))
        rho, sigma = umap_ops.smooth_knn_dist(knn_d, local_connectivity=lc)
        timer.done("smooth_knn_dist")
        heads, tails, weights = umap_ops.fuzzy_simplicial_set(
            knn_i, knn_d, rho, sigma, set_op_mix_ratio=float(p["set_op_mix_ratio"]))
        timer.done("fuzzy_set")

        # 2b. supervised intersection (categorical target metric)
        if y_fit is not None:
            tmetric = str(p.get("target_metric") or "categorical")
            if tmetric != "categorical":
                raise ValueError(
                    f"target_metric='{tmetric}' is not supported; only "
                    "'categorical' supervised UMAP is implemented"
                )
            tw = float(p.get("target_weight", 0.5))
            # umap-learn: far_dist from target_weight; 1.0 -> effectively inf
            far_dist = 2.5 * (1.0 / (1.0 - tw)) if tw < 1.0 else 1.0e12
            known = np.isfinite(y_fit)
            codes = np.full(y_fit.shape[0], -1, np.int32)
            if known.any():
                _, inv = np.unique(y_fit[known], return_inverse=True)
                codes[known] = inv.astype(np.int32)
            weights = umap_ops.categorical_intersection(
                knn_i, heads, tails, weights,
                torch.as_tensor(codes, device=device), far_dist=far_dist)
            timer.done("supervised")

        # 3. a, b of the curve (host scipy, once)
        a, b = p.get("a"), p.get("b")
        if a is None or b is None:
            a, b = umap_ops.find_ab_params(float(p["spread"]), float(p["min_dist"]))
        timer.done("find_ab_params")

        # 4. init, from numpy's generator as in the JAX package (bit-equal)
        dim = int(p["n_components"])
        rng = np.random.default_rng(seed)
        init = str(p["init"])
        if init != "random" and sparse_in and d > _SPARSE_SPECTRAL_MAX_D:
            self.logger.warning(
                f"init='spectral' on sparse input needs a {d}x{d} Gram "
                f"(> {_SPARSE_SPECTRAL_MAX_D} feature cap); using random "
                "init"
            )
            init = "random"
        if init == "random":
            emb0 = rng.uniform(-10.0, 10.0, (n, dim)).astype(dtype)
        else:  # "spectral": the scaled PCA basis + jitter
            if sparse_in:
                pc = _sparse_pca_basis_project(X_fit, min(dim, d), dtype, device)
            else:
                Xc = X_fit - X_fit.mean(axis=0)
                _, _, vt = np.linalg.svd(Xc, full_matrices=False)
                pc = Xc @ vt[: min(dim, d)].T
            pc = pc / max(np.abs(pc).max(), 1e-12) * 10.0
            if dim > pc.shape[1]:  # fewer features than components: pad
                pad = rng.uniform(-10.0, 10.0, (n, dim - pc.shape[1]))
                pc = np.concatenate([pc, pad], axis=1)
            emb0 = (pc + rng.normal(scale=1e-4, size=pc.shape)).astype(dtype)
        timer.done("init")

        # 5. SGD epochs (umap-learn's rule: 500 to 10,000 rows, else 200;
        # an explicit 0 keeps the init)
        n_epochs = p.get("n_epochs")
        n_epochs = int(n_epochs) if n_epochs is not None else (500 if n <= 10000 else 200)
        emb = umap_ops.optimize_embedding(
            torch.as_tensor(emb0, device=device),
            heads,
            tails,
            weights,
            seed,
            n_epochs=n_epochs,
            a=a,
            b=b,
            initial_alpha=float(p["learning_rate"]),
            negative_sample_rate=int(p["negative_sample_rate"]),
            repulsion_strength=float(p["repulsion_strength"]),
            # an explicit random_state asks for reproducible fits: the
            # umap_kernel=auto choice then follows the prior, not a probe
            deterministic=rs is not None,
        )
        model = UMAPModel(
            embedding_=emb.cpu().numpy(),
            raw_data_=X_fit,
            rho_=rho.cpu().numpy(),
            sigma_=sigma.cpu().numpy(),
            a_=float(a),
            b_=float(b),
            n_cols=d,
            dtype=str(np.dtype(dtype).name),
        )
        timer.done("sgd")
        LAST_FIT.update(n_rows=n, n_epochs=n_epochs)
        self._copyValues(model)
        model._tpu_params = dict(self._tpu_params)
        model._num_workers = self._num_workers
        model._float32_inputs = self._float32_inputs
        self.logger.info(f"Finished UMAP fit in {time.time() - t0:.3f}s")
        return model


class UMAPModel(UMAPClass, _TpuModel, _UMAPParams):
    """Fitted UMAP model: the embedding AND the raw training rows (needed
    to embed new points).  A transform finds each query row's neighbours
    among the training rows on the device and places it at the
    membership-weighted mean of their embeddings."""

    def __init__(self, **attrs: Any) -> None:
        super().__init__(**attrs)
        self.embedding_: np.ndarray = np.asarray(attrs["embedding_"])
        raw = attrs["raw_data_"]
        # CSR fits keep the training rows CSR (saved as CSR parts)
        self.raw_data_ = raw.tocsr() if _is_sparse(raw) else np.asarray(raw)
        self.rho_: np.ndarray = np.asarray(attrs["rho_"])
        self.sigma_: np.ndarray = np.asarray(attrs["sigma_"])
        self.a_: float = float(attrs["a_"])
        self.b_: float = float(attrs["b_"])
        self.n_cols: int = int(attrs["n_cols"])
        self.dtype: str = str(attrs.get("dtype", "float32"))
        self._device_items = None  # (key, staged arrays) reused across transforms

    @property
    def embedding(self) -> np.ndarray:
        """pyspark-style accessor."""
        return self.embedding_

    @property
    def rawData(self) -> np.ndarray:
        return self.raw_data_

    def _output_columns(self) -> List[str]:
        return [self.getOrDefault("outputCol")]

    def _staged_items(self, device, dtype, metric: str):
        """The training rows (the metric's row transform applied), their
        validity, int32 positions, rho, sigma and the embedding on the
        device, staged once and reused by later transforms on the same
        device, dtype and metric.  Rows are staged contiguously, so ties
        resolve as in the fit."""
        from ..ops.distances import metric_kind, preprocess_rows
        from ..parallel.mesh import RowStager

        key = (str(device), str(dtype), metric)
        if self._device_items is not None and self._device_items[0] == key:
            return self._device_items[1]
        self._device_items = None  # free the old copy first
        items = self.raw_data_
        st = RowStager(items.shape[0], device)
        row_tf = None
        if metric_kind(metric) == "matmul":
            # the fit's row transform, so distances meet the fit's rho/sigma
            row_tf = lambda c: preprocess_rows(c, metric)  # noqa: E731
        if _is_sparse(items):
            Xi = st.stage_sparse(items, dtype, row_transform=row_tf)
        else:
            Xi = st.stage(items if row_tf is None else np.asarray(row_tf(items), dtype), dtype)
        staged = (Xi, st.mask(dtype), st.row_ids(),
                  st.copy(self.rho_.astype(dtype)), st.copy(self.sigma_.astype(dtype)),
                  st.copy(self.embedding_.astype(dtype)))
        self._device_items = (key, staged)
        return staged

    def _transform_array(self, X) -> Dict[str, np.ndarray]:
        from ..ops.distances import metric_kind, preprocess_rows, umap_knn_graph
        from ..ops.umap import transform_init
        from ..parallel import DeviceContext
        from ..parallel.mesh import RowStager

        k = int(float(self._tpu_params["n_neighbors"]))
        if k > self.raw_data_.shape[0]:
            raise ValueError(
                f"n_neighbors={k} exceeds the {self.raw_data_.shape[0]} "
                f"training rows in the model"
            )
        sparse_q = _is_sparse(X)
        Xq = X.tocsr() if sparse_q else np.ascontiguousarray(X, dtype=self._out_dtype(X))
        dtype = np.dtype(self._out_dtype(Xq))
        metric = str(self._tpu_params.get("metric", "euclidean"))
        pw = float(dict(self._tpu_params.get("metric_kwds") or {}).get("p", 2.0))
        row_tf = None
        if metric_kind(metric) == "matmul":
            row_tf = lambda c: preprocess_rows(c, metric)  # noqa: E731
            if not sparse_q:
                Xq = np.asarray(row_tf(Xq), dtype)
        # a transform runs on the one device whatever worker count was saved
        with DeviceContext() as ctx:
            device = ctx.device
        Xi, valid, ids, rho, sigma, emb = self._staged_items(device, dtype, metric)
        qst = RowStager(Xq.shape[0], device)
        Qs = qst.stage_sparse(Xq, dtype, row_transform=row_tf) if sparse_q else qst.stage(Xq, dtype)
        knn_d, inds = umap_knn_graph(Xi, valid, ids, Qs, k=k, metric=metric, p=pw)
        out = transform_init(inds, knn_d, rho, sigma, emb)
        return {self.getOrDefault("outputCol"): qst.fetch(out)}

    def _get_model_attributes(self) -> Dict[str, Any]:
        return {
            "embedding_": self.embedding_,
            "raw_data_": self.raw_data_,
            "rho_": self.rho_,
            "sigma_": self.sigma_,
            "a_": self.a_,
            "b_": self.b_,
            "n_cols": self.n_cols,
            "dtype": self.dtype,
        }

    def cpu(self):
        raise NotImplementedError(
            "umap-learn is not bundled; the model arrays (embedding_, "
            "raw_data_) are directly consumable"
        )


__all__ = ["UMAP", "UMAPModel"]
