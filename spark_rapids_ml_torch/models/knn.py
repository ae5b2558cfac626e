#
# Exact k-NN: the port of the exact route of
# spark_rapids_ml_tpu/models/knn.py (`NearestNeighbors`,
# `NearestNeighborsModel`).  `fit` keeps the item set on the host;
# `kneighbors` stages items and queries on the device and runs one
# `knn_topk_single` (ops/knn.py), which on the card is the hand-written
# fused kernel.  One device only: the ring over several devices and
# `ApproximateNearestNeighbors` come later.
#
# DataFrames are optional.  With pandas installed, `kneighbors` and the
# join return pandas DataFrames exactly as the JAX package does; without
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

    def _search(self, Q, k: int) -> Tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError

    def kneighbors(
        self, query_df: DatasetLike, sort_knn_df_by_query_id: bool = True
    ) -> Tuple[Any, Any, Any]:
        """(item_df, query_df, knn_df): knn_df holds one row per query,
        `query_id`, `indices` (item ids) and `distances`."""
        Q, q_ids, q_df = _extract_with_ids(self, query_df, keep_sparse=True)
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
        return np.sqrt(qst.fetch(d2)), qst.fetch(idx)

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
