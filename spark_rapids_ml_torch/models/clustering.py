#
# Clustering: the port of spark_rapids_ml_tpu/models/clustering.py,
# KMeans and DBSCAN.  A KMeans fit (from host arrays or a DeviceDataset,
# through core.py's staged fit) runs ops/kmeans.py on the staged rows:
# the seeding, then a Lloyd driven from the host; `transform` is the
# nearest centre of each row, over row chunks.  DBSCAN's fit is deferred,
# as in the JAX package: `DBSCANModel.transform` clusters the rows it is
# given (ops/dbscan.py) and renumbers the clusters by first occurrence.
#
# A parquet file beyond the device budget (or with
# `force_streaming_stats`) fits epoch by epoch: seeding on a strided
# subsample of the file, then one streamed pass per Lloyd iteration
# (streaming.py `kmeans_streaming_fit`).
#
# With `checkpoint_dir` set a KMeans fit takes the stepwise branch and saves
# its centres after every Lloyd iteration under the JAX package's tag
# (`kmeans-mem|...`, the data's fingerprint included); the streamed fit
# checkpoints under its own (streaming.py).
#
# Not ported: the CPU fits and `cpu()` (scikit-learn, which the card's
# machine lacks; ROADMAP.md section 3).  CSR input is densified.
#
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from ..core import FitInput, _TpuEstimator, _TpuModel
from ..params import (
    HasFeaturesCol,
    HasFeaturesCols,
    HasMaxIter,
    HasPredictionCol,
    HasSeed,
    HasTol,
    HasWeightCol,
    Param,
    TypeConverters,
    _TpuParams,
)
from ..utils import _ArrayBatch, get_logger


def _no_sklearn(what: str):
    return NotImplementedError(
        f"{what} uses scikit-learn; the port does not (ROADMAP.md section 3)"
    )


class KMeansClass:
    """Param mapping (Spark name -> backend name)."""

    @classmethod
    def _param_mapping(cls) -> Dict[str, Optional[str]]:
        return {
            "distanceMeasure": None,  # euclidean only
            "initMode": "init",
            "k": "n_clusters",
            "initSteps": "init_steps",
            "maxIter": "max_iter",
            "seed": "random_state",
            "tol": "tol",
            "weightCol": "",  # sample weights are native
            "solver": "",
            "maxBlockSizeInMB": "",
        }

    @classmethod
    def _param_value_mapping(cls):
        def tol_mapper(x: float) -> float:
            if x == 0.0:
                get_logger(cls).warning(
                    "tol=0 mapped to the smallest positive float32 "
                    "(reference clustering.py:108-120)."
                )
                return float(np.finfo("float32").tiny)
            return x

        def init_mapper(x: str):
            return {
                "k-means||": "scalable-k-means++",
                "scalable-k-means++": "scalable-k-means++",
                "k-means++": "k-means++",
                "random": "random",
            }.get(x)

        return {"tol": tol_mapper, "initMode": init_mapper}

    @classmethod
    def _get_tpu_params_default(cls) -> Dict[str, Any]:
        return {
            "n_clusters": 8,
            "max_iter": 300,
            "tol": 0.0001,
            "verbose": False,
            "random_state": None,
            "init": "scalable-k-means++",
            "n_init": "auto",
            "init_steps": 2,
            "oversampling_factor": 2.0,
            "max_samples_per_batch": 32768,
        }


class _KMeansTpuParams(
    _TpuParams,
    HasFeaturesCol,
    HasFeaturesCols,
    HasPredictionCol,
    HasSeed,
    HasTol,
    HasMaxIter,
    HasWeightCol,
):
    """The Params KMeans and its model share."""

    k = Param("_", "k", "The number of clusters to create.", TypeConverters.toInt)
    initMode = Param(
        "_", "initMode", 'The initialization algorithm: "k-means||" or "random".',
        TypeConverters.toString,
    )
    initSteps = Param("_", "initSteps", "The number of steps for k-means|| init.",
                      TypeConverters.toInt)
    distanceMeasure = Param("_", "distanceMeasure", "The distance measure.",
                            TypeConverters.toString)

    def __init__(self) -> None:
        super().__init__()
        self._setDefault(
            k=2, initMode="k-means||", initSteps=2, maxIter=20, tol=1e-4
        )

    def setFeaturesCol(self, value):
        if isinstance(value, str):
            self._set_params(featuresCol=value)
        else:
            self._set_params(featuresCols=value)
        return self

    def setFeaturesCols(self, value: List[str]):
        return self._set_params(featuresCols=value)

    def setPredictionCol(self, value: str):
        self._set(predictionCol=value)
        return self

    def setK(self, value: int):
        return self._set_params(k=value)

    def getK(self) -> int:
        return self.getOrDefault("k")

    def setInitMode(self, value: str):
        return self._set_params(initMode=value)

    def setMaxIter(self, value: int):
        return self._set_params(maxIter=value)

    def setTol(self, value: float):
        return self._set_params(tol=value)

    def setWeightCol(self, value: str):
        return self._set_params(weightCol=value)


class KMeans(KMeansClass, _TpuEstimator, _KMeansTpuParams):
    """KMeans on one GPU, with the JAX package's API: k-means|| (or
    k-means++, or random) seeding on the device, then Lloyd iterations
    driven from the host until every centre moves less than `tol`.

    Examples
    --------
    >>> from spark_rapids_ml_torch import set_default_device
    >>> from spark_rapids_ml_torch.clustering import KMeans
    >>> set_default_device("cpu")
    >>> X = [[0.0, 0.0], [1.0, 1.0], [9.0, 8.0], [8.0, 9.0]]
    >>> model = KMeans(k=2, seed=1).setFeaturesCol("features").fit({"features": X})
    >>> sorted(model.transform({"features": X})["prediction"].tolist())
    [0, 0, 1, 1]
    """

    def __init__(self, **kwargs: Any) -> None:
        super().__init__()
        self._set_params(**kwargs)

    def _supports_streaming_stats(self) -> bool:
        # no sufficient statistics: every Lloyd iteration streams the file
        return True

    def _fit_streaming(self, path: str) -> Dict[str, Any]:
        """Beyond the device budget: centres seeded from a strided
        subsample of the file, then one streamed assign-and-sum pass per
        Lloyd iteration (streaming.py `kmeans_streaming_fit`)."""
        from ..resilience.checkpoint import resolve_checkpoint_dir
        from ..streaming import kmeans_streaming_fit

        fcol, fcols, _, weight_col, dtype = self._streaming_io_params()
        p = self._tpu_params
        seed = p.get("random_state")
        res = kmeans_streaming_fit(
            path, fcol, fcols, weight_col,
            k=int(p["n_clusters"]),
            seed=int(seed) if seed is not None else int(self.getOrDefault("seed")),
            max_iter=int(p["max_iter"]),
            tol=float(p["tol"]),
            init=str(p["init"]),
            init_steps=int(p.get("init_steps") or 2),
            oversample=float(p.get("oversampling_factor") or 2.0),
            dtype=dtype,
            checkpoint_dir=resolve_checkpoint_dir(streaming=True) or None,
            device=self._device(),
        )
        dtype = np.dtype(dtype)
        return {
            "cluster_centers_": np.asarray(res["centers"]).astype(dtype),
            "inertia_": float(res["cost"]),
            "n_iter_": int(res["n_iter"]),
            "n_cols": int(res["d"]),
            "dtype": str(dtype.name),
        }

    def _fit_array(self, fit_input: FitInput) -> Dict[str, Any]:
        from ..core import _fit_fingerprint
        from ..ops.kmeans import kmeans_fit_auto
        from ..resilience.checkpoint import checkpoint_file_for, resolve_checkpoint_dir

        p = fit_input.params
        k = int(p["n_clusters"])
        seed = p.get("random_state")
        seed = int(seed) if seed is not None else int(self.getOrDefault("seed"))
        max_iter = int(p["max_iter"])
        ckpt_dir = resolve_checkpoint_dir()
        ckpt_path, ckpt_tag = None, ""
        if ckpt_dir:
            # the JAX package's tag; n is the rows staged, never a padded count
            ckpt_tag = (f"kmeans-mem|n={int(fit_input.n_valid)}|d={fit_input.pdesc.n}|k={k}"
                        f"|seed={seed}|mi={max_iter}|tol={p['tol']}|{_fit_fingerprint(fit_input)}")
            ckpt_path = checkpoint_file_for(ckpt_dir, ckpt_tag)
        centers, cost, n_iter, stepwise = kmeans_fit_auto(
            fit_input.X,
            fit_input.w,
            k=k,
            seed=seed,
            max_iter=max_iter,
            tol=float(p["tol"]),
            init=str(p["init"]),
            init_steps=int(p.get("init_steps") or 2),
            oversample=float(p.get("oversampling_factor") or 2.0),
            checkpoint_path=ckpt_path,
            checkpoint_tag=ckpt_tag,
        )
        if stepwise:
            self.logger.info("KMeans: stepwise branch (seeding on a strided subsample)")
        return {
            "cluster_centers_": centers.cpu().numpy(),
            "inertia_": float(cost),
            "n_iter_": int(n_iter),
            "n_cols": fit_input.pdesc.n,
            "dtype": str(np.dtype(fit_input.dtype).name),
        }

    def _create_model(self, attrs: Dict[str, Any]) -> "KMeansModel":
        return KMeansModel(**attrs)

    def _cpu_fit(self, batch: _ArrayBatch) -> "KMeansModel":
        raise _no_sklearn("KMeans' CPU fit")


class KMeansSummary:
    """pyspark KMeansSummary analog: the training-cost surface."""

    def __init__(self, trainingCost: float, k: int, numIter: int) -> None:
        self.trainingCost = float(trainingCost)
        self.k = int(k)
        self.numIter = int(numIter)


class KMeansModel(KMeansClass, _TpuModel, _KMeansTpuParams):
    """A fitted KMeans: the centres, the training cost and the iterations;
    `transform` appends the nearest centre of each row."""

    def __init__(self, **attrs: Any) -> None:
        super().__init__(**attrs)
        self.cluster_centers_: np.ndarray = np.asarray(attrs["cluster_centers_"])
        self.inertia_: float = float(attrs.get("inertia_", 0.0))
        self.n_iter_: int = int(attrs.get("n_iter_", 0))
        self.n_cols: int = int(attrs["n_cols"])
        self.dtype: str = str(attrs.get("dtype", "float32"))
        self._set_params(k=int(self.cluster_centers_.shape[0]))

    def clusterCenters(self) -> List[np.ndarray]:
        """pyspark.ml parity: list of center vectors."""
        return list(self.cluster_centers_)

    @property
    def hasSummary(self) -> bool:
        return True

    @property
    def summary(self) -> "KMeansSummary":
        """pyspark parity: the weighted training cost and the iterations."""
        return KMeansSummary(
            trainingCost=self.inertia_,
            k=int(self.cluster_centers_.shape[0]),
            numIter=self.n_iter_,
        )

    def predict(self, value) -> int:
        """Nearest-centre id of ONE sample, on the host in float64."""
        v = np.asarray(value, np.float64).reshape(-1)
        C = self.cluster_centers_.astype(np.float64)
        if v.shape[0] != C.shape[1]:
            raise ValueError(
                f"feature vector has {v.shape[0]} entries; model expects "
                f"{C.shape[1]}"
            )
        return int(np.argmin(((C - v) ** 2).sum(axis=1)))

    def _transform_device(self, Xs) -> Dict[str, Any]:
        import torch

        from ..ops.kmeans import kmeans_predict

        C = torch.tensor(self.cluster_centers_, device=Xs.device).to(Xs.dtype)
        return {self.getOrDefault("predictionCol"): kmeans_predict(Xs, C)}

    def cpu(self):
        raise _no_sklearn("KMeansModel.cpu()")


# ---------------------------------------------------------------------------
# DBSCAN
# ---------------------------------------------------------------------------


class DBSCANClass:
    """Param surface: cuML's names (Spark MLlib has no DBSCAN)."""

    @classmethod
    def _param_mapping(cls) -> Dict[str, Optional[str]]:
        return {"eps": "eps", "min_samples": "min_samples", "metric": "metric"}

    @classmethod
    def _get_tpu_params_default(cls) -> Dict[str, Any]:
        return {
            "eps": 0.5,
            "min_samples": 5,
            "metric": "euclidean",
            "max_mbytes_per_batch": None,
            "verbose": False,
            "calc_core_sample_indices": False,
        }


class _DBSCANTpuParams(
    _TpuParams, HasFeaturesCol, HasFeaturesCols, HasPredictionCol
):
    eps = Param("_", "eps",
                "The maximum distance between two samples for one to be "
                "considered in the neighborhood of the other.",
                TypeConverters.toFloat)
    min_samples = Param("_", "min_samples",
                        "The number of samples in a neighborhood (including "
                        "the point itself) for a point to be a core point.",
                        TypeConverters.toInt)
    metric = Param("_", "metric", "Distance metric: euclidean or cosine.",
                   TypeConverters.toString)

    def __init__(self) -> None:
        super().__init__()
        self._setDefault(eps=0.5, min_samples=5, metric="euclidean")

    def setFeaturesCol(self, value):
        if isinstance(value, str):
            self._set_params(featuresCol=value)
        else:
            self._set_params(featuresCols=value)
        return self

    def setFeaturesCols(self, value: List[str]):
        return self._set_params(featuresCols=value)

    def setPredictionCol(self, value: str):
        self._set(predictionCol=value)
        return self

    def setEps(self, value: float):
        return self._set_params(eps=value)

    def getEps(self) -> float:
        return self.getOrDefault("eps")

    def setMinSamples(self, value: int):
        return self._set_params(min_samples=value)

    def getMinSamples(self) -> int:
        return self.getOrDefault("min_samples")

    def setMetric(self, value: str):
        return self._set_params(metric=value)

    def getMetric(self) -> str:
        return self.getOrDefault("metric")


class DBSCAN(DBSCANClass, _TpuEstimator, _DBSCANTpuParams):
    """DBSCAN on one GPU, with the JAX package's API.  `fit` is deferred:
    it returns a model holding the params, and `DBSCANModel.transform`
    clusters the rows it is given.

    Examples
    --------
    >>> from spark_rapids_ml_torch import set_default_device
    >>> from spark_rapids_ml_torch.clustering import DBSCAN
    >>> set_default_device("cpu")
    >>> rows = {"features": [[0.0], [0.1], [0.2], [9.0], [9.1], [50.0]]}
    >>> model = DBSCAN(eps=0.5, min_samples=2).setFeaturesCol("features").fit(rows)
    >>> model.transform(rows)["prediction"].tolist()
    [0, 0, 0, 1, 1, -1]
    """

    def __init__(self, **kwargs: Any) -> None:
        super().__init__()
        self._set_params(**kwargs)

    def _fit(self, dataset) -> "DBSCANModel":
        if str(self._tpu_params.get("metric", "euclidean")) not in ("euclidean", "cosine"):
            raise ValueError("DBSCAN metric must be euclidean or cosine")
        model = DBSCANModel(n_cols=0, dtype="float32")  # no attributes until transform
        self._copyValues(model)
        model._tpu_params = dict(self._tpu_params)
        model._num_workers = self._num_workers
        model._float32_inputs = self._float32_inputs
        return model


class DBSCANModel(DBSCANClass, _TpuModel, _DBSCANTpuParams):
    """Deferred-fit DBSCAN model: `transform` clusters the given rows and
    appends the label column (-1 = noise, clusters numbered by first
    occurrence, as scikit-learn)."""

    def __init__(self, **attrs: Any) -> None:
        super().__init__(**attrs)
        self.n_cols = int(attrs.get("n_cols", 0))
        self.dtype = str(attrs.get("dtype", "float32"))

    def _transform_array(self, X: np.ndarray) -> Dict[str, np.ndarray]:
        from ..ops.dbscan import _ADJ_BUDGET, dbscan_fit_predict
        from ..parallel import DeviceContext
        from ..parallel.mesh import RowStager

        eps = float(self._tpu_params["eps"])
        if str(self._tpu_params.get("metric", "euclidean")) == "cosine":
            # cosine_dist <= eps on unit vectors  <=>  ||u-v|| <= sqrt(2 eps)
            norms = np.linalg.norm(X, axis=1, keepdims=True)
            X = X / np.maximum(norms, 1e-12)
            eps = float(np.sqrt(2.0 * eps))
        # one device labels the rows whatever worker count was saved
        with DeviceContext() as ctx:
            device = ctx.device
        dtype = self._out_dtype(X)
        st = RowStager(X.shape[0], device)
        Xs = st.stage(X, dtype)
        mb = self._tpu_params.get("max_mbytes_per_batch")
        # cuML's max_mbytes_per_batch: a byte cap on the distance tile
        budget = max(int(float(mb) * 1024 * 1024), 1) if mb else _ADJ_BUDGET
        labels, _core = dbscan_fit_predict(
            Xs, st.mask(dtype), eps, int(self._tpu_params["min_samples"]), adj_budget=budget,
        )
        return {self.getOrDefault("predictionCol"): renumber(st.fetch(labels))}

    def cpu(self):
        raise _no_sklearn("DBSCANModel.cpu()")


def renumber(labels: np.ndarray) -> np.ndarray:
    """Cluster representatives -> consecutive ids by first occurrence in
    row order (int64), -1 (noise) kept."""
    out = np.full(labels.shape, -1, np.int64)
    clustered = labels >= 0
    if clustered.any():
        _, first_pos, inverse = np.unique(
            labels[clustered], return_index=True, return_inverse=True
        )
        order = np.argsort(first_pos, kind="stable")
        rank = np.empty_like(order)
        rank[order] = np.arange(order.size)
        out[clustered] = rank[inverse]
    return out
