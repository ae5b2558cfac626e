#
# Pipeline: the port of spark_rapids_ml_tpu/pipeline.py, a pyspark.ml-style
# Pipeline whose fit finds a [VectorAssembler, estimator] pair and feeds the
# assembler's scalar input columns straight to the estimator as its
# featuresCols (`_maybe_bypass_assembler`): packing them into an array
# column first would only be copied apart again.
#
from __future__ import annotations

from typing import Any, List, Optional

import numpy as np

from .core import Estimator, Model, Transformer, _TpuEstimator
from .data import DatasetLike
from .params import Param, TypeConverters
from .utils import get_logger


class VectorAssembler(Transformer):
    """pyspark.ml.feature.VectorAssembler parity for the pandas data plane:
    packs scalar input columns into one array-valued column."""

    inputCols = Param("_", "inputCols", "input column names.",
                      TypeConverters.toListString)
    outputCol = Param("_", "outputCol", "output column name.",
                      TypeConverters.toString)

    def __init__(
        self,
        inputCols: Optional[List[str]] = None,
        outputCol: Optional[str] = None,
    ) -> None:
        super().__init__()
        if inputCols is not None:
            self._set(inputCols=inputCols)
        if outputCol is not None:
            self._set(outputCol=outputCol)

    def setInputCols(self, value: List[str]) -> "VectorAssembler":
        self._set(inputCols=value)
        return self

    def setOutputCol(self, value: str) -> "VectorAssembler":
        self._set(outputCol=value)
        return self

    def getInputCols(self) -> List[str]:
        return self.getOrDefault("inputCols")

    def getOutputCol(self) -> str:
        return self.getOrDefault("outputCol")

    def _transform(self, dataset: DatasetLike):
        import pandas as pd

        if not isinstance(dataset, pd.DataFrame):
            raise TypeError("VectorAssembler requires a pandas DataFrame")
        cols = self.getOrDefault("inputCols")
        out = dataset.copy()
        out[self.getOrDefault("outputCol")] = list(
            np.ascontiguousarray(dataset[cols].to_numpy(np.float64))
        )
        return out


class NoOpTransformer(Transformer):
    """Identity stage standing in for a bypassed assembler (reference
    pipeline.py:52-62)."""

    def _transform(self, dataset: DatasetLike):
        return dataset


class Pipeline(Estimator):
    """pyspark.ml.Pipeline parity with the reference's assembler bypass
    (reference pipeline.py:52-159).

    Examples
    --------
    >>> import numpy as np, pandas as pd
    >>> from spark_rapids_ml_torch.pipeline import Pipeline, VectorAssembler
    >>> from spark_rapids_ml_torch.classification import LogisticRegression
    >>> rng = np.random.default_rng(0)
    >>> df = pd.DataFrame({"a": rng.normal(size=100), "b": rng.normal(size=100)})
    >>> df["label"] = (df["a"] > 0).astype(float)
    >>> pipe = Pipeline(stages=[
    ...     VectorAssembler(inputCols=["a", "b"], outputCol="features"),
    ...     LogisticRegression(maxIter=50),
    ... ])
    >>> model = pipe.fit(df)
    >>> float((model.transform(df)["prediction"] == df["label"]).mean()) > 0.9
    True
    """

    def __init__(self, stages: Optional[List[Any]] = None) -> None:
        super().__init__()
        self._stages: List[Any] = stages or []
        self.logger = get_logger(type(self))

    def setStages(self, value: List[Any]) -> "Pipeline":
        self._stages = value
        return self

    def getStages(self) -> List[Any]:
        return self._stages

    def _maybe_bypass_assembler(self, stages: List[Any]) -> List[Any]:
        """Replace [VectorAssembler -> accelerated estimator] with
        [NoOp -> estimator(featuresCols=input scalars)] (reference
        pipeline.py:85-119)."""
        out = list(stages)
        for i in range(len(out) - 1):
            st, nxt = out[i], out[i + 1]
            if (
                isinstance(st, VectorAssembler)
                and isinstance(nxt, _TpuEstimator)
                and nxt.hasParam("featuresCols")
                and st.isSet("inputCols")
                and st.isSet("outputCol")
            ):
                features_col = (
                    nxt.getOrDefault("featuresCol")
                    if nxt.hasParam("featuresCol") and nxt.isDefined("featuresCol")
                    else None
                )
                if features_col == st.getOrDefault("outputCol"):
                    est = nxt.copy()
                    est.setFeaturesCol(st.getOrDefault("inputCols"))
                    out[i] = NoOpTransformer()
                    out[i + 1] = est
                    self.logger.info(
                        "Bypassing VectorAssembler: feeding scalar columns "
                        f"{st.getOrDefault('inputCols')} directly"
                    )
        return out

    def _fit(self, dataset: DatasetLike) -> "PipelineModel":
        stages = self._maybe_bypass_assembler(self._stages)
        fitted: List[Any] = []
        df = dataset
        for i, stage in enumerate(stages):
            if isinstance(stage, Transformer):
                fitted.append(stage)
                df = stage.transform(df)
            elif isinstance(stage, Estimator):
                model = stage.fit(df)
                fitted.append(model)
                if i < len(stages) - 1:
                    df = model.transform(df)
            else:
                raise TypeError(f"Pipeline stage {stage} is neither "
                                "Estimator nor Transformer")
        return PipelineModel(fitted)


class PipelineModel(Model):
    """Fitted pipeline (pyspark PipelineModel parity)."""

    def __init__(self, stages: List[Any]) -> None:
        super().__init__()
        self.stages = stages

    def _transform(self, dataset: DatasetLike):
        df = dataset
        for stage in self.stages:
            df = stage.transform(df)
        return df


__all__ = [
    "Pipeline",
    "PipelineModel",
    "VectorAssembler",
    "NoOpTransformer",
]
