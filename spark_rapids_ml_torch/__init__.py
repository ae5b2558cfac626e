#
# spark_rapids_ml_torch — the PyTorch/CUDA port of spark_rapids_ml_tpu, for
# one NVIDIA Hopper GPU.  The same estimator and model names, Params, conf
# keys and on-disk model format as the JAX package; plain tensor code is
# PyTorch, and the JAX package's one Pallas kernel is a CUDA C++ kernel
# written for sm_90a (ops/fused_knn.py, ops/csrc/fused_knn.cu).
#
# Ported so far: exact and approximate NearestNeighbors (IVF-Flat, IVF-PQ,
# CAGRA; `spark_rapids_ml_torch.knn`) with the metric kNN of
# `ops/distances.py`, LogisticRegression and RandomForestClassifier
# (`spark_rapids_ml_torch.classification`), PCA
# (`spark_rapids_ml_torch.feature`), LinearRegression and
# RandomForestRegressor (`spark_rapids_ml_torch.regression`), KMeans and
# DBSCAN (`spark_rapids_ml_torch.clustering`), and UMAP
# (`spark_rapids_ml_torch.umap`: fit, dense and CSR, supervised, and
# transform through the fused kernel), with the generic staged fit,
# the fused stage-and-solve pass, the chunked transform, `DeviceDataset`, the
# fits from parquet and beyond the card's memory (`streaming`) with the chunk
# cache's replays (`parallel.device_cache`), the one-pass statistics
# (`stats`: `summarize`, `Summarizer`, `describe`), and the meta layer:
# `metrics`, the evaluators (`evaluation`), `fitMultiple`, CrossValidator on
# the stage-once dataset cache (`tuning`) and `pipeline`.
#
# Entry points run on "cuda:0" unless the caller asks for the CPU with
# `set_default_device("cpu")` or SPARK_RAPIDS_ML_TORCH_DEVICE=cpu; without
# a CUDA device and such a request they raise.
#
import sys as _sys

__version__ = "0.1.0"

from . import config  # noqa: F401
from .data import DeviceDataset  # noqa: F401
from .models import classification, clustering, feature, knn, regression, umap  # noqa: F401
from .parallel import get_default_device, set_default_device  # noqa: F401
from . import evaluation, metrics, pipeline, tuning  # noqa: F401,E402

_sys.modules[__name__ + ".knn"] = knn
_sys.modules[__name__ + ".classification"] = classification
_sys.modules[__name__ + ".clustering"] = clustering
_sys.modules[__name__ + ".feature"] = feature
_sys.modules[__name__ + ".regression"] = regression
_sys.modules[__name__ + ".umap"] = umap
