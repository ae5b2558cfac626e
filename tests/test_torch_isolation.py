#
# The port stands alone: no module of spark_rapids_ml_torch, nor
# chip_smoke.py or compare_kernels.py, imports JAX or the JAX package; the port runs with both
# made unimportable (ApproximateNearestNeighbors' three algorithms, and its
# fits from parquet included: streaming.py and the
# parquet readers of fused.py, the chunk cache and the statistics; and the
# meta layer: a CrossValidator fit, and the load of a CrossValidatorModel the
# JAX package saved, which names the JAX package's model class; and UMAP,
# whose import alone brings in neither); and
# chip_smoke.py refuses to run without a CUDA device or without the rest of
# the repo.
#
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "spark_rapids_ml_torch"
FORBIDDEN = ("jax", "jaxlib", "spark_rapids_ml_tpu")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py", REPO / "compare_kernels.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_port_module_imports_jax(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def _run(code: str, cwd=REPO, env_extra=None, timeout=240):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def _jax_saved_cv_model(path: str) -> None:
    """A CrossValidatorModel the JAX package fits and saves at `path`."""
    import numpy as np
    import pandas as pd

    from spark_rapids_ml_tpu.evaluation import RegressionEvaluator
    from spark_rapids_ml_tpu.regression import LinearRegression
    from spark_rapids_ml_tpu.tuning import CrossValidator, ParamGridBuilder

    rng = np.random.default_rng(3)
    X = rng.normal(size=(90, 4))
    df = pd.DataFrame({"features": list(X), "label": X @ np.array([1.0, 2.0, 3.0, 4.0])})
    lr = LinearRegression(num_workers=1)
    grid = ParamGridBuilder().addGrid(lr.regParam, [0.0, 1.0]).build()
    CrossValidator(estimator=lr, estimatorParamMaps=grid, evaluator=RegressionEvaluator(),
                   numFolds=2, seed=1).fit(df).save(path)


def test_port_runs_with_jax_unimportable(tmp_path):
    cv_dir = str(tmp_path / "jax_cv")
    _jax_saved_cv_model(cv_dir)
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        "sys.modules['spark_rapids_ml_tpu'] = None\n"
        "import numpy as np\n"
        "import spark_rapids_ml_torch as p\n"
        "from spark_rapids_ml_torch.knn import NearestNeighbors\n"
        "import spark_rapids_ml_torch.convert, chip_smoke\n"
        "p.set_default_device('cpu')\n"
        "rng = np.random.default_rng(0)\n"
        "X = rng.normal(size=(50, 4)).astype(np.float32)\n"
        "_, _, df = NearestNeighbors(k=3).fit(X).kneighbors(X[:5])\n"
        "idx = np.stack(df['indices'])\n"
        "assert (idx[:, 0] == np.arange(5)).all(), idx\n"
        "from spark_rapids_ml_torch.knn import ApproximateNearestNeighbors\n"
        "for algo in ('ivfflat', 'ivfpq', 'cagra'):\n"
        "    ann = ApproximateNearestNeighbors(k=3, algorithm=algo, algoParams={\n"
        "        'nlist': 4, 'M': 2, 'graph_degree': 8}).fit(X)\n"
        "    idx = np.stack(ann.kneighbors(X[:5])[2]['indices'])\n"
        "    assert idx.shape == (5, 3) and (algo == 'ivfpq' or (idx[:, 0] == np.arange(5)).all())\n"
        "from spark_rapids_ml_torch.classification import LogisticRegression\n"
        "y = (X[:, 0] > 0).astype(np.float64)\n"
        "pred = LogisticRegression(regParam=0.01).fit((X, y)).transform(X)['prediction']\n"
        "assert (pred == y).mean() > 0.9\n"
        "from spark_rapids_ml_torch.feature import PCA\n"
        "from spark_rapids_ml_torch.regression import LinearRegression\n"
        "from spark_rapids_ml_torch import config\n"
        "config.set_config(fused_stage_solve='on')\n"
        "assert PCA(k=2).fit(X).transform(X).shape == (50, 2)\n"
        "yl = X @ np.arange(4.0) + 1.0\n"
        "assert abs(LinearRegression().fit((X, yl)).intercept - 1.0) < 1e-4\n"
        "from spark_rapids_ml_torch.clustering import DBSCAN, KMeans\n"
        "Xc = np.concatenate([X[:25] - 20.0, X[25:] + 20.0])\n"
        "lab = KMeans(k=2, seed=1).fit(Xc).transform(Xc)\n"
        "assert len(set(lab[:25])) == 1 and lab[0] != lab[-1]\n"
        "lab = DBSCAN(eps=10.0, min_samples=3).fit(Xc).transform(Xc)\n"
        "assert lab.tolist() == [0] * 25 + [1] * 25, lab\n"
        "from spark_rapids_ml_torch.classification import RandomForestClassifier\n"
        "from spark_rapids_ml_torch.regression import RandomForestRegressor\n"
        "rf = RandomForestClassifier(numTrees=3, maxDepth=4, seed=2).fit((Xc, lab))\n"
        "assert (rf.transform(Xc)['prediction'] == lab).all()\n"
        "assert (rf.cpu().predict(Xc) == lab).all()\n"
        "rr = RandomForestRegressor(numTrees=3, maxDepth=4, bootstrap=False).fit((Xc, 2.0 * lab))\n"
        "assert np.allclose(rr.transform(Xc), 2.0 * lab)\n"
        "import os, tempfile\n"
        "import pyarrow as pa, pyarrow.parquet as pq\n"
        "path = os.path.join(tempfile.mkdtemp(), 'x.parquet')\n"
        "pq.write_table(pa.table({'features': pa.FixedSizeListArray.from_arrays(\n"
        "    pa.array(X.reshape(-1)), 4), 'label': pa.array(y)}), path, row_group_size=20)\n"
        "config.set_config(fused_stage_solve='on')\n"
        "assert PCA(k=2).fit(path).fit_report()['route'] == 'fused_parquet'\n"
        "config.set_config(force_streaming_stats=True)\n"
        "for est in (LogisticRegression(regParam=0.01), LinearRegression(), KMeans(k=2, seed=1)):\n"
        "    assert est.fit(path).fit_report()['route'] == 'streamed'\n"
        "config.reset_config()\n"
        "assert RandomForestClassifier(numTrees=1).fit(path).fit_report()['route'] == 'staged_parquet'\n"
        "import pandas as pd\n"
        "from spark_rapids_ml_torch.evaluation import RegressionEvaluator\n"
        "from spark_rapids_ml_torch.tuning import CrossValidator, CrossValidatorModel, "
        "ParamGridBuilder\n"
        "df = pd.DataFrame({'features': list(X), 'label': yl})\n"
        "lin = LinearRegression()\n"
        "cv = CrossValidator(estimator=lin, estimatorParamMaps=ParamGridBuilder().addGrid(\n"
        "    lin.regParam, [0.0, 1.0]).build(), evaluator=RegressionEvaluator(), numFolds=2)\n"
        "m = cv.fit(df)\n"
        "assert m.bestIndex == 0 and m.fit_report()['used_cache'], m.fit_report()\n"
        f"loaded = CrossValidatorModel.load({cv_dir!r})\n"
        "assert type(loaded.bestModel) is type(m.bestModel) and loaded.bestIndex == 0\n"
        "assert loaded.transform(df)['prediction'].shape == (50,)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
        "'spark_rapids_ml_tpu') and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_cache_and_summarize_run_with_jax_unimportable():
    """The chunk cache's replay, a DuHL-sampled streamed fit and `summarize`
    of a parquet file (a decode, then a replay) run with JAX and the JAX
    package unimportable."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        "sys.modules['spark_rapids_ml_tpu'] = None\n"
        "import os, tempfile\n"
        "import numpy as np, pyarrow as pa, pyarrow.parquet as pq\n"
        "import spark_rapids_ml_torch as p\n"
        "from spark_rapids_ml_torch import config, streaming\n"
        "from spark_rapids_ml_torch.parallel.device_cache import CHUNK_METRICS\n"
        "from spark_rapids_ml_torch.stats import summarize, describe\n"
        "p.set_default_device('cpu')\n"
        "rng = np.random.default_rng(0)\n"
        "X = rng.normal(size=(3000, 4)).astype(np.float32)\n"
        "y = (X[:, 0] > 0).astype(np.float64)\n"
        "path = os.path.join(tempfile.mkdtemp(), 'x.parquet')\n"
        "pq.write_table(pa.table({'features': pa.FixedSizeListArray.from_arrays(\n"
        "    pa.array(X.reshape(-1)), 4), 'label': pa.array(y)}), path, row_group_size=500)\n"
        "a = streaming.linreg_streaming_stats(path, 'features', (), 'label', None, chunk_rows=400)\n"
        "b = streaming.linreg_streaming_stats(path, 'features', (), 'label', None, chunk_rows=400)\n"
        "assert CHUNK_METRICS['hits'] == 1 and (a['gram'] == b['gram']).all()\n"
        "config.set_config(streaming_chunk_sampling='duhl')\n"
        "r = streaming.kmeans_streaming_fit(path, 'features', (), None, k=3, seed=1, chunk_rows=400)\n"
        "assert 'sampled_epochs' in r and np.isfinite(r['cost'])\n"
        "config.reset_config()\n"
        "s1 = summarize(path, metrics=['count', 'mean', 'distinctCount', 'quantiles'])\n"
        "s2 = summarize(path, metrics=['count', 'mean', 'distinctCount', 'quantiles'])\n"
        "assert s1['count'] == 3000 and (s1['mean'] == s2['mean']).all()\n"
        "assert abs(s1['mean'] - X.mean(axis=0)).max() < 1e-5\n"
        "assert describe(X).shape == (8, 4)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
        "'spark_rapids_ml_tpu') and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_umap_imports_and_fits_without_jax():
    """`spark_rapids_ml_torch.umap` in a fresh interpreter: neither JAX nor
    the JAX package is in `sys.modules` after the import, and a fit,
    transform, save and load run with both unimportable."""
    code = (
        "import sys\n"
        "import spark_rapids_ml_torch.umap\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
        "'spark_rapids_ml_tpu')]\n"
        "assert not bad, bad\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        "sys.modules['spark_rapids_ml_tpu'] = None\n"
        "import os, tempfile\n"
        "import numpy as np, scipy.sparse as sp\n"
        "import spark_rapids_ml_torch as p\n"
        "from spark_rapids_ml_torch.umap import UMAP, UMAPModel\n"
        "p.set_default_device('cpu')\n"
        "X = np.random.default_rng(0).normal(size=(120, 6)).astype(np.float32)\n"
        "m = UMAP(n_neighbors=8, n_epochs=20, random_state=0).fit(X)\n"
        "path = os.path.join(tempfile.mkdtemp(), 'u')\n"
        "m.save(path)\n"
        "assert (UMAPModel.load(path).transform(X[:7]) == m.transform(X[:7])).all()\n"
        "c = UMAP(n_neighbors=8, n_epochs=5, init='spectral').fit(sp.csr_matrix(X))\n"
        "assert np.isfinite(c.embedding_).all()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
        "'spark_rapids_ml_tpu') and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_entry_point_raises_for_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    code = (
        "import numpy as np\n"
        "from spark_rapids_ml_torch.knn import NearestNeighbors\n"
        "X = np.zeros((5, 2), np.float32)\n"
        "NearestNeighbors(k=2).fit(X).kneighbors(X)\n"
    )
    out = _run(code, env_extra={"SPARK_RAPIDS_ML_TORCH_DEVICE": "cuda"})
    assert out.returncode != 0
    assert "RuntimeError" in out.stderr and "no CUDA device" in out.stderr


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_refuses_without_cuda_or_repo(tmp_path, where):
    if torch.cuda.is_available() and where == "repo":
        pytest.skip("checks the behaviour without a CUDA device")
    cwd = REPO
    if where == "alone":
        (tmp_path / "chip_smoke.py").write_text((REPO / "chip_smoke.py").read_text())
        cwd = tmp_path
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
                         text=True, timeout=240,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_sparse_and_resilience_run_with_jax_unimportable(tmp_path):
    """The ELL route (ops/sparse.py) and the resilience layer (resilience/):
    a CSR fit, a checkpointed fit killed by an injected preemption and
    resumed, and a retried transform run with JAX and the JAX package
    unimportable."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        "sys.modules['spark_rapids_ml_tpu'] = None\n"
        "import numpy as np, scipy.sparse as sp\n"
        "import spark_rapids_ml_torch as p\n"
        "from spark_rapids_ml_torch import config, resilience\n"
        "from spark_rapids_ml_torch.classification import LogisticRegression\n"
        "p.set_default_device('cpu')\n"
        "rng = np.random.default_rng(0)\n"
        "X = rng.normal(size=(200, 6)); X[rng.random(X.shape) > 0.5] = 0.0\n"
        "y = (X[:, 0] > 0).astype(float)\n"
        "a = LogisticRegression(regParam=0.01, maxIter=30).fit((sp.csr_matrix(X), y))\n"
        f"config.set_config(checkpoint_dir={str(tmp_path)!r}, retry_max_attempts=1)\n"
        "try:\n"
        "    with resilience.fault_inject('lbfgs_iteration', 'preemption', skip=3):\n"
        "        LogisticRegression(regParam=0.01, maxIter=30).fit((sp.csr_matrix(X), y))\n"
        "    raise AssertionError('not killed')\n"
        "except resilience.SimulatedPreemption:\n"
        "    pass\n"
        "b = LogisticRegression(regParam=0.01, maxIter=30).fit((sp.csr_matrix(X), y))\n"
        "assert (a.coef_ == b.coef_).all()\n"
        "assert [e.detail for e in resilience.get_events('lbfgs_resume')] == ['it=3']\n"
        "config.reset_config()\n"
        "with resilience.fault_inject('transform_dispatch', 'oom'):\n"
        "    out = b.transform(X)\n"
        "assert (out['prediction'] == a.transform(X)['prediction']).all()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
        "'spark_rapids_ml_tpu') and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
