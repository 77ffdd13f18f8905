"""The port's eigendecomposition of small symmetric float64 matrices
(``ops/smallsvd.eigh_desc``) against the JAX package's ``jnp.linalg.eigh``
(reordered descending), on the CPU, where ``eigh_desc`` runs its plain
version; ``tests/test_torch_gpu.py`` holds the Jacobi kernel to that plain
version on the card.  Eigenvalues and reconstructions V diag(w) V^T are
compared to 1e-12 of the input's max-abs, never the vectors themselves
(their signs, and their bases inside degenerate subspaces, are free).

Also the kernel's launch geometry (``eigh_geometry``), which is pure
Python: every 1 <= k <= 64 fits in one block's shared memory and k = 65 is
refused; and that every line ``tools/probe_eigh.py`` replaces to make its
variants of the kernel is still in the kernel's source."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from matrixproductbp_tpu_torch.ops import build, smallsvd
from matrixproductbp_tpu_torch.tools import probe_eigh

TOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: torch's intra-op threads would only contend
    with the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grams(kind, k, B=6, seed=0):
    """float64 [B, k, k]: Gram matrices of Gaussian [2k, k] matrices, of
    rank-k/2 ones, or matrices with a 5-fold degenerate eigenvalue."""
    rng = np.random.default_rng(seed + k)
    if kind == "degenerate":
        Q = np.linalg.qr(rng.standard_normal((B, k, k)))[0]
        ev = rng.standard_normal((B, k))
        ev[:, :5] = 2.0
        return (Q * ev[:, None, :]) @ Q.transpose(0, 2, 1)
    X = rng.standard_normal((B, 2 * k, k))
    if kind == "rankdef":
        X[:, :, k // 2:] = 0.0
    return X.transpose(0, 2, 1) @ X


@pytest.mark.parametrize("kind", ["gauss", "rankdef", "degenerate"])
@pytest.mark.parametrize("k", [5, 20, 33, 40])
def test_eigh_desc_matches_jax_eigh(k, kind):
    G = _grams(kind, k)
    w, V = (x.numpy() for x in smallsvd.eigh_desc(torch.as_tensor(G)))
    jw, jV = (np.asarray(x)[..., ::-1] for x in jnp.linalg.eigh(
        jnp.asarray(G)))
    scale = np.abs(G).max()
    assert np.all(w[:, :-1] >= w[:, 1:])
    assert np.abs(w - jw).max() <= TOL * scale
    rec = (V * w[:, None, :]) @ V.transpose(0, 2, 1)
    jrec = (jV * jw[:, None, :]) @ jV.transpose(0, 2, 1)
    assert np.abs(rec - jrec).max() <= TOL * scale
    assert np.abs(rec - G).max() <= TOL * scale


def test_eigh_geometry_fits_every_k_and_refuses_65():
    for k in range(1, smallsvd.MAX_K + 1):
        K, mpb, smem = smallsvd.eigh_geometry(k)
        assert K in smallsvd.EIGH_SIZES and k <= K and K % 2 == 0
        assert mpb * (32 if K <= 32 else 64) == 128
        assert smem <= build.SMEM_PER_BLOCK
        assert smem >= mpb * 8 * K * (K + 1)      # A at the padded stride
    assert smallsvd.eigh_geometry(20)[:2] == (20, 4)   # several per block
    assert smallsvd.eigh_geometry(40)[0] == 40
    for k in (0, 65):
        with pytest.raises(ValueError, match="1 <= k <= 64"):
            smallsvd.eigh_geometry(k)


def test_probe_variants_apply_to_the_kernel_source():
    with open(probe_eigh.SOURCE) as fh:
        text = fh.read()
    sources = probe_eigh.variant_sources(text)
    assert set(sources) == set(probe_eigh.VARIANTS)
    assert all(src != text for src in sources.values())
    with pytest.raises(RuntimeError, match="six_sweeps"):
        probe_eigh.variant_sources(text.replace("1e-28 * fro", "1e-28*fro"))
