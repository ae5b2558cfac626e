#
# k-NN: the port of spark_rapids_ml_tpu/models/knn.py, exact and
# approximate, on one device.
#
# `NearestNeighbors` keeps the item set on the host; `kneighbors` stages
# items and queries on the device and runs one `knn_topk_single`
# (ops/knn.py), which on the card is the hand-written fused kernel.
# `ApproximateNearestNeighbors` builds an index at fit (ops/ivf.py
# IVF-Flat and IVF-PQ, ops/cagra.py's NN-descent graph), stages it on the
# device once, and searches it in query chunks bounded by `hbm_bytes`;
# the final candidates are re-scored exactly on the host in float32, so the
# reported distances are the JAX package's for the same candidates.  The
# ring over several devices waits for ROADMAP.md item 8.
#
# DataFrames are optional.  With pandas installed, `kneighbors` and the
# joins return pandas DataFrames exactly as the JAX package does; without
# it, numpy and CSR inputs still work and the results are dicts of numpy
# columns under the same names ("indices" then holds one (n_queries, k)
# array).
#
from __future__ import annotations

import sys
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

from ..core import _TpuEstimator, _TpuModel, _resolve_feature_params
from ..data import DatasetLike, _ensure_dense, _is_sparse, extract_arrays
from ..params import (
    HasFeaturesCol,
    HasFeaturesCols,
    HasIDCol,
    Param,
    TypeConverters,
    _TpuParams,
)
from ..utils import timer_span


def _pandas():
    """The pandas module, or None where it is not installed."""
    try:
        import pandas as pd
    except ImportError:
        return None
    return pd


def _frame(cols: Dict[str, Any]):
    """A pandas DataFrame of `cols` where pandas exists, else `cols`."""
    pd = _pandas()
    return cols if pd is None else pd.DataFrame(cols)


class _NNClass:
    """Param mapping (Spark name -> backend name)."""

    @classmethod
    def _param_mapping(cls) -> Dict[str, Optional[str]]:
        return {"k": "n_neighbors"}

    @classmethod
    def _get_tpu_params_default(cls) -> Dict[str, Any]:
        return {"n_neighbors": 5, "verbose": False}


class _KNNParams(_TpuParams, HasFeaturesCol, HasFeaturesCols, HasIDCol):
    k = Param("_", "k", "The number of nearest neighbors to retrieve.",
              TypeConverters.toInt)

    def __init__(self) -> None:
        super().__init__()
        self._setDefault(k=5)

    def setK(self, value: int):
        return self._set_params(k=value)

    def getK(self) -> int:
        return self.getOrDefault("k")

    def setFeaturesCol(self, value: Union[str, List[str]]):
        if isinstance(value, str):
            self._set_params(featuresCol=value)
        else:
            self._set_params(featuresCols=value)
        return self

    def setFeaturesCols(self, value: List[str]):
        return self._set_params(featuresCols=value)

    def setIdCol(self, value: str):
        return self._set_params(idCol=value)


def _extract_with_ids(
    inst, dataset: DatasetLike, keep_sparse: bool = False
) -> Tuple[Any, np.ndarray, Any]:
    """(X, ids, source DataFrame or None).  Ids come from the
    idCol when the user names one, else they are row positions.  With
    `keep_sparse` a CSR input stays CSR (staged dense chunk by chunk)."""
    features_col, features_cols = _resolve_feature_params(inst)
    id_col = (
        inst.getOrDefault("idCol")
        if inst.hasParam("idCol") and inst.isSet("idCol")
        else None
    )
    batch = extract_arrays(
        dataset,
        features_col=features_col,
        features_cols=features_cols,
        id_col=id_col,
        dtype=None,
        supervised=False,
    )
    if keep_sparse and _is_sparse(batch.X):
        X = batch.X.tocsr()
    else:
        X = _ensure_dense(batch.X)
    if batch.row_id is not None:
        ids = np.asarray(batch.row_id)
    else:
        ids = np.arange(X.shape[0], dtype=np.int64)
    # a DataFrame can only be one if pandas is already imported
    pd = sys.modules.get("pandas")
    df = dataset if pd is not None and isinstance(dataset, pd.DataFrame) else None
    return X, ids, df


def _assemble_knn_df(q_ids, indices, dist, sort_by_query_id: bool):
    dist = dist.astype(np.float32)
    pd = _pandas()
    if pd is None:
        order = (
            np.argsort(q_ids, kind="stable") if sort_by_query_id
            else np.arange(len(q_ids))
        )
        return {
            "query_id": np.asarray(q_ids)[order],
            "indices": indices[order],
            "distances": dist[order],
        }
    knn_df = pd.DataFrame(
        {"query_id": q_ids, "indices": list(indices), "distances": list(dist)}
    )
    if sort_by_query_id:
        knn_df = knn_df.sort_values("query_id", ignore_index=True)
    return knn_df


def _flatten_join(knn_df, distCol: str, drop_invalid: bool):
    """Vectorized (item_id, query_id, dist) flattening of a knn_df."""
    idx = np.stack(knn_df["indices"])
    dist = np.stack(knn_df["distances"])
    k = idx.shape[1]
    cols = {
        "item_id": idx.reshape(-1),
        "query_id": np.repeat(np.asarray(knn_df["query_id"]), k),
        distCol: dist.reshape(-1).astype(np.float64),
    }
    if drop_invalid:
        keep = (cols["item_id"] >= 0) & np.isfinite(cols[distCol])
        cols = {name: col[keep] for name, col in cols.items()}
    return _frame(cols)


class _NNModelBase(_TpuModel):
    """kneighbors/join surface."""

    item_features: Any
    item_ids: np.ndarray
    _item_df: Any
    # exact search stages CSR queries chunk by chunk; the ANN index probes
    # take dense host queries
    _sparse_query_ok = False

    def _search(self, Q, k: int) -> Tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError

    def _metric(self) -> str:
        if self.hasParam("metric"):
            return str(self._tpu_params.get("metric", self.getOrDefault("metric")))
        return "euclidean"

    def _apply_metric(self, d2: np.ndarray) -> np.ndarray:
        """Squared euclidean -> the requested metric.  Cosine search runs on
        unit vectors, where 1 - cos = ||u - v||^2 / 2."""
        metric = self._metric()
        if metric == "sqeuclidean":
            return d2
        if metric == "euclidean":
            return np.sqrt(d2)
        if metric == "cosine":
            return d2 / 2.0
        raise ValueError(
            f"metric '{metric}' is not supported; use euclidean, "
            "sqeuclidean, or cosine"
        )

    def kneighbors(
        self, query_df: DatasetLike, sort_knn_df_by_query_id: bool = True
    ) -> Tuple[Any, Any, Any]:
        """(item_df, query_df, knn_df): knn_df holds one row per query,
        `query_id`, `indices` (item ids) and `distances`; an unreachable
        slot of an approximate search is id -1 at distance inf."""
        Q, q_ids, q_df = _extract_with_ids(self, query_df,
                                           keep_sparse=self._sparse_query_ok)
        k = int(self._tpu_params.get("n_neighbors", self.getOrDefault("k")))
        dist, pos = self._search(Q, k)
        indices = np.where(pos >= 0, self.item_ids[np.maximum(pos, 0)], -1)
        knn_df = _assemble_knn_df(q_ids, indices, dist, sort_knn_df_by_query_id)
        item_df = self._item_df
        if item_df is None:
            item_df = _frame({"id": self.item_ids})
        return item_df, q_df, knn_df

    def _transform(self, dataset: DatasetLike):
        raise NotImplementedError(
            f"{type(self).__name__} does not support transform(); use "
            "kneighbors() or the join method."
        )

    def cpu(self):
        from sklearn.neighbors import NearestNeighbors as SkNN

        sk = SkNN(n_neighbors=int(self.getOrDefault("k")), algorithm="brute")
        sk.fit(self.item_features)
        return sk


def _finalize_nn_fit(est, model, df):
    model._item_df = df
    est._copyValues(model)
    model._tpu_params = dict(est._tpu_params)
    model._num_workers = est._num_workers
    model._float32_inputs = est._float32_inputs
    return model


class NearestNeighbors(_NNClass, _TpuEstimator, _KNNParams):
    """Exact brute-force k nearest neighbors.

    `fit` only captures the item set; `kneighbors` does the work, on the
    device.

    Examples
    --------
    >>> import numpy as np
    >>> from spark_rapids_ml_torch import set_default_device
    >>> from spark_rapids_ml_torch.knn import NearestNeighbors
    >>> set_default_device("cpu")
    >>> items = np.array([[0.0, 0.0], [1.0, 1.0], [5.0, 5.0]])
    >>> queries = np.array([[0.2, 0.2], [4.9, 5.1]])
    >>> model = NearestNeighbors(k=1).fit(items)
    >>> _, _, knn_df = model.kneighbors(queries)
    >>> [int(i[0]) for i in knn_df["indices"]]
    [0, 2]
    """

    def __init__(self, **kwargs: Any) -> None:
        super().__init__()
        self._set_params(**kwargs)

    def _fit(self, dataset: DatasetLike) -> "NearestNeighborsModel":
        X, ids, df = _extract_with_ids(self, dataset, keep_sparse=True)
        # one process holds the whole item set: nothing is distributed
        model = NearestNeighborsModel(
            item_features=X,
            item_ids=ids,
            n_cols=int(X.shape[1]),
            dtype=str(X.dtype),
        )
        return _finalize_nn_fit(self, model, df)


class NearestNeighborsModel(_NNClass, _NNModelBase, _KNNParams):
    """Fitted exact k-NN model."""

    _sparse_query_ok = True

    def __init__(self, **attrs: Any) -> None:
        super().__init__(**attrs)
        feats = attrs["item_features"]
        self.item_features = feats.tocsr() if _is_sparse(feats) else np.asarray(feats)
        self.item_ids: np.ndarray = np.asarray(attrs["item_ids"])
        self.n_cols = int(attrs.get("n_cols", self.item_features.shape[1]))
        self.dtype = str(attrs.get("dtype", self.item_features.dtype))
        self._item_df = None
        self._device_items = None  # (key, staged items) reused across searches

    def _staged_items(self, device, dtype):
        """Item rows, validity and int32 positions on the device, staged
        once and reused by later searches on the same device and dtype."""
        from ..parallel.mesh import RowStager

        key = (str(device), str(dtype))
        if self._device_items is not None and self._device_items[0] == key:
            return self._device_items[1]
        st = RowStager(self.item_features.shape[0], device)
        feats = self.item_features
        staged = (
            st.stage_sparse(feats, dtype) if _is_sparse(feats) else st.stage(feats, dtype),
            st.mask(dtype),
            st.row_ids(),
        )
        self._device_items = (key, staged)
        return staged

    def _search(self, Q, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """(euclidean distances, item positions) of the k nearest items."""
        from ..ops.knn import knn_topk_single
        from ..parallel import DeviceContext, RowStager

        n_items = self.item_features.shape[0]
        if k > n_items:
            raise ValueError(f"k={k} exceeds the number of items ({n_items})")
        # one device searches every item whatever worker count was saved
        with DeviceContext() as ctx:
            device = ctx.device
        dtype = self._out_dtype(self.item_features)
        items, valid, ids = self._staged_items(device, dtype)
        qst = RowStager(Q.shape[0], device)
        queries = qst.stage_sparse(Q, dtype) if _is_sparse(Q) else qst.stage(Q, dtype)
        d2, idx = knn_topk_single(items, valid, ids, queries, k=k)
        return self._apply_metric(qst.fetch(d2)), qst.fetch(idx)

    def exactNearestNeighborsJoin(self, query_df: DatasetLike, distCol: str = "distCol"):
        """Flattened (item_id, query_id, distance) join."""
        _, _, knn_df = self.kneighbors(query_df)
        return _flatten_join(knn_df, distCol, drop_invalid=False)

    def _get_model_attributes(self) -> Dict[str, Any]:
        return {
            "item_features": self.item_features,
            "item_ids": self.item_ids,
            "n_cols": self.n_cols,
            "dtype": self.dtype,
        }


class _ANNClass:
    """Param mapping (Spark name -> backend name)."""

    @classmethod
    def _param_mapping(cls) -> Dict[str, Optional[str]]:
        return {"k": "n_neighbors", "algorithm": "algorithm",
                "algoParams": "algo_params", "metric": "metric"}

    @classmethod
    def _get_tpu_params_default(cls) -> Dict[str, Any]:
        return {
            "n_neighbors": 5,
            "algorithm": "ivfflat",
            "algo_params": None,
            "metric": "euclidean",
            "verbose": False,
        }


class _ANNParams(_KNNParams):
    algorithm = Param("_", "algorithm",
                      "ANN algorithm: ivfflat, ivfpq, or cagra.",
                      TypeConverters.toString)
    algoParams = Param("_", "algoParams",
                       "algorithm-specific parameters (nlist/nprobe/M/n_bits/"
                       "refine_ratio).", TypeConverters.identity)
    metric = Param("_", "metric", "distance metric (euclidean/sqeuclidean/cosine).",
                   TypeConverters.toString)

    def __init__(self) -> None:
        super().__init__()
        self._setDefault(algorithm="ivfflat", metric="euclidean")

    def setAlgorithm(self, value: str):
        return self._set_params(algorithm=value)

    def getAlgorithm(self) -> str:
        return self.getOrDefault("algorithm")

    def setAlgoParams(self, value: Dict[str, Any]):
        return self._set_params(algoParams=value)

    def setMetric(self, value: str):
        return self._set_params(metric=value)


_SUPPORTED_ANN_ALGOS = ("ivfflat", "ivfpq", "cagra")
# the model attributes each algorithm's search takes, in its op's order
_INDEX_ARRAYS = {
    "ivfflat": ("ivf_centers", "ivf_buckets", "ivf_bucket_ids", "ivf_bucket_valid",
                "ivf_sub_table"),
    "ivfpq": ("ivf_centers", "pq_codebooks", "pq_codes", "ivf_bucket_ids",
              "ivf_bucket_valid", "ivf_sub_table"),
    "cagra": ("item_features", "cagra_graph"),
}


def _unit_rows(X: np.ndarray) -> np.ndarray:
    """Rows scaled to unit norm (cosine: the index and the queries)."""
    return X / np.maximum(np.linalg.norm(X, axis=1, keepdims=True), 1e-12).astype(np.float32)


class ApproximateNearestNeighbors(_ANNClass, _TpuEstimator, _ANNParams):
    """Approximate k nearest neighbors.

    `fit` builds the index on the device: an ops/kmeans.py coarse quantizer
    and the inverted file (`ivfflat`), plus per-subspace residual codebooks
    (`ivfpq`), or an NN-descent kNN graph searched by beam traversal
    (`cagra`, ops/cagra.py).  `kneighbors` searches the index staged on the
    device and re-scores the final candidates exactly.

    algoParams:
      - nlist: number of inverted lists (default ~sqrt(n))
      - nprobe: lists probed per query (default 20, clamped to nlist)
      - M / n_bits: ivfpq subspaces / code bits (defaults 8 / 8)
      - refine_ratio: ivfpq exact re-rank multiplier (default 2)
      - graph_degree / nn_descent_niter: cagra graph degree (default 32)
        and NN-descent build rounds (default 8)
      - nn_descent_sample: cagra local-join width per round (default
        graph_degree; pass 2*graph_degree for the exhaustive join)
      - itopk_size / max_iterations: cagra search beam width (default 64)
        and traversal iterations (default 12)

    Examples
    --------
    >>> import numpy as np
    >>> from spark_rapids_ml_torch import set_default_device
    >>> from spark_rapids_ml_torch.knn import ApproximateNearestNeighbors
    >>> set_default_device("cpu")
    >>> X = np.random.default_rng(0).normal(size=(256, 16)).astype("float32")
    >>> ann = ApproximateNearestNeighbors(k=4, algoParams={"nlist": 8, "nprobe": 8})
    >>> _, _, knn_df = ann.fit(X).kneighbors(X[:10])
    >>> [int(i[0]) for i in knn_df["indices"]] == list(range(10))
    True
    """

    def __init__(self, **kwargs: Any) -> None:
        super().__init__()
        self._set_params(**kwargs)

    def _fit(self, dataset: DatasetLike) -> "ApproximateNearestNeighborsModel":
        from ..ops import ivf as ivf_ops
        from ..parallel import DeviceContext

        X, ids, df = _extract_with_ids(self, dataset)
        X = np.ascontiguousarray(X, dtype=np.float32)
        algo = str(self._tpu_params.get("algorithm", "ivfflat")).lower()
        if algo not in _SUPPORTED_ANN_ALGOS:
            raise ValueError(
                f"algorithm '{algo}' is not supported; choose from "
                f"{_SUPPORTED_ANN_ALGOS}"
            )
        metric = str(self._tpu_params.get("metric", "euclidean"))
        if metric not in ("euclidean", "sqeuclidean", "cosine"):
            raise ValueError(
                f"metric '{metric}' is not supported; use euclidean, "
                "sqeuclidean, or cosine"
            )
        # one process holds every item; several devices raise here
        with DeviceContext(self.num_workers) as ctx:
            device = ctx.device
        if metric == "cosine":
            # cosine == euclidean on unit vectors / 2: the index is built
            # over normalized items (queries normalize at search)
            X = _unit_rows(X)
        ap = dict(self._tpu_params.get("algo_params") or {})
        n = X.shape[0]
        nlist = int(ap.get("nlist", max(1, min(int(np.sqrt(n)), n))))
        nlist = max(1, min(nlist, n))
        attrs: Dict[str, Any] = {
            "item_features": X,
            "item_ids": ids,
            "n_cols": int(X.shape[1]),
            "dtype": str(X.dtype),
            "algorithm": algo,
            "nlist": nlist,
        }
        if algo == "cagra":
            from ..ops.cagra import build_cagra_graph
            from ..parallel import RowStager

            deg = int(ap.get("graph_degree", 32))
            deg = max(1, min(deg, n - 1))
            rounds = int(ap.get("nn_descent_niter", 8))
            sample = ap.get("nn_descent_sample")
            graph = build_cagra_graph(
                RowStager(n, device).stage(X, np.float32),
                seed=0,
                deg=deg,
                rounds=max(rounds, 1),
                sample=None if sample is None else int(sample),
            )
            attrs.update(cagra_graph=graph.cpu().numpy())
        elif algo == "ivfflat":
            index = ivf_ops.build_ivfflat(X, nlist=nlist, device=device)
            attrs.update(
                ivf_centers=index.centers,
                ivf_buckets=index.buckets,
                ivf_bucket_ids=index.bucket_ids,
                ivf_bucket_valid=index.bucket_valid,
                ivf_sub_table=index.sub_table,
            )
        else:  # ivfpq
            M = int(ap.get("M", 8))
            d = X.shape[1]
            if d % M != 0:  # shrink M to a divisor
                M = next(m for m in range(min(M, d), 0, -1) if d % m == 0)
            n_bits = int(ap.get("n_bits", 8))
            if not 1 <= n_bits <= 8:
                # codes are stored uint8; >8 bits would silently wrap
                raise ValueError(f"ivfpq n_bits must be in [1, 8], got {n_bits}")
            index = ivf_ops.build_ivfpq(X, nlist=nlist, M=M, n_bits=n_bits, device=device)
            attrs.update(
                ivf_centers=index.centers,
                pq_codebooks=index.codebooks,
                pq_codes=index.codes,
                ivf_bucket_ids=index.bucket_ids,
                ivf_bucket_valid=index.bucket_valid,
                ivf_sub_table=index.sub_table,
                pq_M=M,
            )
        model = ApproximateNearestNeighborsModel(**attrs)
        return _finalize_nn_fit(self, model, df)


class ApproximateNearestNeighborsModel(_ANNClass, _NNModelBase, _ANNParams):
    """Fitted ANN model.  Saved as the JAX package saves it
    (`metadata.json` + `arrays.npz`): either package loads the other's."""

    def __init__(self, **attrs: Any) -> None:
        super().__init__(**attrs)
        self.item_features: np.ndarray = np.asarray(attrs["item_features"])
        self.item_ids: np.ndarray = np.asarray(attrs["item_ids"])
        self.n_cols = int(attrs.get("n_cols", self.item_features.shape[1]))
        self.dtype = str(attrs.get("dtype", self.item_features.dtype))
        self.algorithm_: str = str(attrs.get("algorithm", "ivfflat"))
        self.nlist_: int = int(attrs.get("nlist", 1))
        if (
            self.algorithm_ in ("ivfflat", "ivfpq")
            and "ivf_sub_table" not in attrs
            and "ivf_centers" in attrs
        ):
            # models saved before sub-list splitting: every list is its own
            # (only) sub-list, the identity table
            attrs["ivf_sub_table"] = np.arange(
                np.asarray(attrs["ivf_centers"]).shape[0], dtype=np.int32
            )[:, None]
        self._attrs = attrs
        self._item_df = None
        self._device_index = None  # (key, staged arrays) reused across searches

    def _staged_index(self, names, device):
        """The index's arrays on `device`, staged once and reused by later
        searches of the same arrays on the same device."""
        from ..parallel import RowStager

        key = (names, str(device))
        if self._device_index is None or self._device_index[0] != key:
            self._device_index = None  # free the old copy first
            arrays = [np.ascontiguousarray(np.asarray(self._attrs[n])) for n in names]
            staged = tuple(RowStager(a.shape[0], device).copy(a) for a in arrays)
            self._device_index = (key, staged)
        return self._device_index[1]

    def _search(self, Q: np.ndarray, k: int, timer=None) -> Tuple[np.ndarray, np.ndarray]:
        """Chunked search: the query chunk bounds the candidate working set
        (IVF gathers one sub-list of cap x d floats per query a step, CAGRA
        beam x deg x d) to an eighth of `hbm_bytes` (None: the device's
        memory).  `timer`, where given, has a `span(name)` around the
        search op's parts (ops/ivf.py, ops/cagra.py) and the "rerank"."""
        from ..parallel import DeviceContext
        from ..parallel.device_cache import device_memory_bytes

        n_items = int(self.item_features.shape[0])
        if k > n_items:
            raise ValueError(
                f"k={k} exceeds the number of indexed items ({n_items})"
            )
        Q = np.ascontiguousarray(Q, dtype=np.float32)
        if self._metric() == "cosine":
            Q = _unit_rows(Q)  # the index holds unit vectors
        with DeviceContext() as ctx:
            device = ctx.device
        nq = int(Q.shape[0])
        per_q = self._per_query_candidate_bytes(k)
        budget = device_memory_bytes(device) // 8
        chunk = max(1, min(nq, budget // max(per_q, 1)))
        if nq <= chunk:
            return self._search_chunk(Q, k, device, timer)
        outs = [
            self._search_chunk(Q[lo : lo + chunk], k, device, timer)
            for lo in range(0, nq, chunk)
        ]
        return (
            np.concatenate([d for d, _ in outs]),
            np.concatenate([p for _, p in outs]),
        )

    def _per_query_candidate_bytes(self, k: int) -> int:
        ap = dict(self._tpu_params.get("algo_params") or {})
        d = int(self.n_cols)
        if self.algorithm_ == "cagra":
            deg = int(self._attrs["cagra_graph"].shape[1])
            beam = max(int(ap.get("itopk_size", 64)), k)
            width = beam * (1 + deg) + deg
        elif self.algorithm_ == "ivfflat":
            # the fold visits ONE sub-list per step: per query a single
            # (cap, d) gather and its distances
            width = int(self._attrs["ivf_buckets"].shape[1])
        else:  # ivfpq: one (cap, M) code gather per step + the per-parent
            # lookup tables (nprobe, M, ksub), live across the whole fold
            mb = int(self._attrs["pq_codes"].shape[1])
            M = int(self._attrs.get("pq_M", 8))
            ksub = int(self._attrs["pq_codebooks"].shape[1])
            nprobe = max(1, min(int(ap.get("nprobe", 20)), self.nlist_))
            return (mb * (M * 4 + 8) + nprobe * M * ksub) * 4
        # distances + gathered vectors + dedup/sort keys, ~2x slack
        return width * (d + 4) * 4 * 2

    def _search_chunk(self, Q: np.ndarray, k: int, device, timer=None
                      ) -> Tuple[np.ndarray, np.ndarray]:
        from ..ops import ivf as ivf_ops
        from ..parallel import RowStager

        qst = RowStager(Q.shape[0], device)
        Qs = qst.stage(Q, np.float32)
        ap = dict(self._tpu_params.get("algo_params") or {})
        # nprobe counts DISTINCT coarse parent cells; the search expands
        # each to its sub-lists
        nprobe = max(1, min(int(ap.get("nprobe", 20)), self.nlist_))
        index = self._staged_index(_INDEX_ARRAYS[self.algorithm_], device)
        if self.algorithm_ == "cagra":
            from ..ops.cagra import search_cagra

            beam = max(int(ap.get("itopk_size", 64)), k)
            iters = int(ap.get("max_iterations", 12))
            _, pos = search_cagra(Qs, *index, k=k, beam=beam, iters=max(iters, 1), timer=timer)
        elif self.algorithm_ == "ivfflat":
            _, pos = ivf_ops.search_ivfflat(Qs, *index, nprobe=nprobe, k=k, timer=timer)
        else:
            refine = int(ap.get("refine_ratio", 2))
            k2 = min(max(k * refine, k), self.item_features.shape[0])
            _, pos = ivf_ops.search_ivfpq(Qs, *index, nprobe=nprobe, k=k2, timer=timer)
        # the kernels rank by matmul-identity distances, whose float32
        # cancellation leaves ~1e-4 absolute error; the final candidates
        # are re-scored in the difference form, so reported distances are
        # exact and near-ties order correctly
        pos = qst.fetch(pos)
        with timer_span(timer, "rerank"):
            return self._exact_rerank(Q, pos, k)

    def _exact_rerank(self, Q: np.ndarray, pos: np.ndarray, k: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact difference-form re-score and re-rank of a (q, >=k)
        candidate block on the host, in float32; invalid slots (pos < 0)
        sort last and stay -1."""
        safe = np.maximum(pos, 0)
        cand = self.item_features[safe]  # (q, k2, d)
        diff = cand - Q[:, None, :]
        exact = (diff * diff).sum(axis=2).astype(np.float32)
        exact = np.where(pos >= 0, exact, np.inf)
        order = np.argsort(exact, axis=1, kind="stable")[:, :k]
        d2 = np.take_along_axis(exact, order, axis=1)
        out_pos = np.take_along_axis(pos, order, axis=1)
        return self._apply_metric(d2), out_pos

    def approxSimilarityJoin(self, query_df: DatasetLike, distCol: str = "distCol"):
        """Flattened approximate join; slots with no reachable candidate
        are dropped."""
        _, _, knn_df = self.kneighbors(query_df)
        return _flatten_join(knn_df, distCol, drop_invalid=True)

    def _get_model_attributes(self) -> Dict[str, Any]:
        return dict(self._attrs)


__all__ = [
    "NearestNeighbors",
    "NearestNeighborsModel",
    "ApproximateNearestNeighbors",
    "ApproximateNearestNeighborsModel",
]
