#
# UMAP's ops and fit on the card: the structured epoch's segment sum uses
# no atomics, so its epochs (and a whole fit with random_state set, which
# takes the structured form on a card) repeat bit for bit; float64 epochs
# on the card meet the CPU's from the same handed-in draws; a fit and a
# transform run through the fused kernel.  Every test here needs a CUDA
# device and skips without one.  This file imports no JAX:
#
#     python -m pytest --noconftest -q tests/test_torch_umap_cuda.py
#
import numpy as np
import pytest
import torch

from spark_rapids_ml_torch import set_default_device
from spark_rapids_ml_torch import config as port_config
from spark_rapids_ml_torch.ops import fused_knn as fk
from spark_rapids_ml_torch.ops import umap as uops

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    set_default_device("cuda:0")
    yield torch.device("cuda:0")
    set_default_device(None)
    port_config.reset_config()


def _blobs(n=3000, d=16, centres=8, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    C = rng.uniform(-10, 10, (centres, d))
    return (C[rng.integers(0, centres, n)] + rng.normal(size=(n, d))).astype(dtype)


def _edges(n=2000, k=10, seed=1, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    knn = np.stack([rng.choice(n, size=k, replace=False) for _ in range(n)])
    heads = torch.as_tensor(np.repeat(np.arange(n), k))
    tails = torch.as_tensor(knn.reshape(-1))
    w = torch.as_tensor(rng.uniform(0.1, 1.0, n * k)).to(dtype)
    emb0 = torch.as_tensor(rng.uniform(-10, 10, (n, 2))).to(dtype)
    return emb0, heads, tails, w


def _draws(n_epochs, E, n, seed=2):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, n, (E, 5)) for _ in range(n_epochs)]


def test_structured_segment_sum_repeats_bit_for_bit(cuda_device):
    emb0, heads, tails, w = (t.to(cuda_device) for t in _edges())
    n, E = emb0.shape[0], heads.shape[0]
    outs = []
    for _ in range(3):
        st = uops._Epochs(emb0, heads, tails, w, 0, 50, 1.58, 0.9, 1.0, 5, 1.0,
                          _draws(20, E, n))
        st.prepare_structured()
        st.run(0, 20, True)
        outs.append(st.emb)
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    # the segment sum alone: every tail's edges added in one order
    _, _, perm, lengths = st.structured_arrays
    g = torch.randn(E, 2, device=cuda_device)
    a = torch.segment_reduce(g[perm], "sum", lengths=lengths, axis=0, unsafe=True)
    b = torch.segment_reduce(g[perm], "sum", lengths=lengths, axis=0, unsafe=True)
    assert torch.equal(a, b)
    want = torch.zeros(n, 2, dtype=torch.float64).index_add_(0, tails.cpu(), g.cpu().double())
    torch.testing.assert_close(a.cpu().double(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("structured", [False, True], ids=["generic", "structured"])
def test_float64_epochs_on_the_card_match_the_cpu(cuda_device, structured):
    """6 float64 epochs from the same draws: the card within 1e-9 of the
    CPU (the exp and pow of the two differ in the last place, and the SGD
    grows that about tenfold an epoch: 10 epochs reached 4.3e-9 on an
    H100)."""
    emb0, heads, tails, w = _edges(dtype=torch.float64)
    draws = _draws(6, heads.shape[0], emb0.shape[0])
    out = {}
    for dev in ("cpu", cuda_device):
        st = uops._Epochs(*(t.to(dev) for t in (emb0, heads, tails, w)), 0, 6, 1.58, 0.9,
                          1.0, 5, 1.0, draws)
        st.prepare_structured()
        st.run(0, 6, structured)
        out[str(dev)] = st.emb.cpu()
    torch.testing.assert_close(out["cuda:0"], out["cpu"], rtol=1e-9, atol=1e-9)


def test_same_seed_fit_repeats_on_the_card(cuda_device):
    from spark_rapids_ml_torch.umap import UMAP

    X = _blobs()
    fk.LAUNCHES = 0
    a = UMAP(n_neighbors=15, random_state=0, n_epochs=100).fit(X)
    assert fk.LAUNCHES >= 1  # the brute-force graph ran the fused kernel
    assert uops.LAST_KERNEL_DECISION["kernel"] == "structured"
    assert uops.LAST_KERNEL_DECISION["decided_by"] == "random-state-platform-prior"
    b = UMAP(n_neighbors=15, random_state=0, n_epochs=100).fit(X)
    np.testing.assert_array_equal(a.embedding_, b.embedding_)
    np.testing.assert_array_equal(a.transform(X[:500]), b.transform(X[:500]))


def test_card_fit_and_transform_match_the_cpu_from_the_same_graph(cuda_device):
    """n_epochs=0: the card's graph, fuzzy set and init against the CPU's
    (rho within the distances' precision, the init bit for bit), and a
    transform within 1e-4."""
    from spark_rapids_ml_torch.umap import UMAP

    X = _blobs(seed=3)
    card = UMAP(n_neighbors=10, random_state=1, n_epochs=0).fit(X)
    set_default_device("cpu")
    cpu = UMAP(n_neighbors=10, random_state=1, n_epochs=0).fit(X)
    np.testing.assert_array_equal(card.embedding_, cpu.embedding_)
    X64 = X.astype(np.float64)
    scale = (X64 * X64).sum(1) + (X64 * X64).sum(1).max()
    assert (np.abs(card.rho_.astype(np.float64) ** 2 - cpu.rho_.astype(np.float64) ** 2)
            <= 1e-5 * scale).all()
    q_cpu = cpu.transform(X[:300])
    set_default_device("cuda:0")
    np.testing.assert_allclose(card.transform(X[:300]), q_cpu, rtol=1e-4, atol=1e-4)
