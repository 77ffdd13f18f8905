"""The port's checkpoint API against the JAX package's (CPU).

* ``save_checkpoint`` / ``load_checkpoint`` round trips, bit for bit with
  ``step`` and ``extra``, for a time-constant SIS state, a time-varying
  one, a periodic one and a banded (``yy_off``, cropped ``ydims``) Glauber
  one, each after one sweep.
* The same states across packages: the port's file loads through the JAX
  ``load_checkpoint``, the JAX ``save_checkpoint`` of that state loads
  through the port's, and every leaf comes back bit for bit.
* Resuming from a checkpoint reproduces the uninterrupted run (``qr``,
  f64, 1e-12; ``tests/test_checkpoint.py:33-52``).
* ``CheckpointManager``: asynchronous saves, ``keep=2`` retention,
  ``restore()`` of the latest, ``FileNotFoundError`` on an empty
  directory, a write that fails on the writer thread raising on
  ``wait()``, and a leftover ``.tmp`` file that is no step.
"""
import os
import shutil

import numpy as np
import pytest
import torch

from matrixproductbp_tpu import checkpoint as jckpt
import matrixproductbp_tpu_torch as tp
from matrixproductbp_tpu_torch.convert import (_GRAPH_LEAVES, _STATE_LEAVES,
                                               _TABLE_LEAVES)
from matrixproductbp_tpu_torch.models import (SIS, SISFactorSpec, Glauber,
                                              Ising, mpbp_glauber, mpbp_sis)

KINDS = ["constant", "time_varying", "periodic", "glauber"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: torch's intra-op threads would only contend
    with the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _graph():
    return tp.random_regular_graph(12, 3, np.random.default_rng(3))


def _state(kind):
    """A small state of ``kind`` after one ``qr`` sweep."""
    g = _graph()
    if kind == "glauber":
        ising = Ising(g, J=[0.5] * (g.E // 2), h=np.linspace(-0.2, 0.3, g.N),
                      beta=0.7)
        bp = mpbp_glauber(Glauber(ising, T=3), D=6, device="cpu")
        assert bp.tables.yy_off is not None and bp.tables.ydims is not None
    elif kind == "time_varying":
        specs = [[SISFactorSpec(0.3 if t < 2 else 0.1, 0.2) for t in range(4)]
                 for _ in range(g.N)]
        bp = tp.mpbp(g, tp.build_tables_t(g, specs), T=3, D=6,
                     phi=SIS(g, 0.3, 0.2, T=3, gamma=0.3).default_phi(),
                     device="cpu")
    else:
        bp = mpbp_sis(SIS(g, lam=0.3, rho=0.2, T=3, gamma=0.3), D=6,
                      periodic=kind == "periodic", device="cpu")
    return tp.bp_sweep(bp, tp.TruncBond(6), method="qr")


def _assert_same_state(a, b):
    for name in _STATE_LEAVES:
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    for name in _TABLE_LEAVES:
        assert torch.equal(getattr(a.tables, name), getattr(b.tables, name))
    for name in _GRAPH_LEAVES:
        np.testing.assert_array_equal(getattr(a.graph, name),
                                      getattr(b.graph, name))
    assert (a.periodic, a.tables.yy_off, a.tables.ydims) == \
        (b.periodic, b.tables.yy_off, b.tables.ydims)


@pytest.mark.parametrize("kind", KINDS)
def test_save_load_roundtrip(tmp_path, kind):
    bp = _state(kind)
    path = tp.save_checkpoint(str(tmp_path / "ckpt"), bp, step=7,
                              extra={"note": "hi", "sweeps": [1, 2]})
    assert path.endswith("ckpt.npz") and os.path.exists(path)
    assert not os.path.exists(path + ".tmp")
    bp2, meta = tp.load_checkpoint(path, device="cpu")
    assert meta["step"] == 7
    assert meta["extra"] == {"note": "hi", "sweeps": [1, 2]}
    _assert_same_state(bp, bp2)
    np.testing.assert_array_equal(tp.beliefs(bp).numpy(),
                                  tp.beliefs(bp2).numpy())


@pytest.mark.parametrize("kind", KINDS)
def test_files_cross_packages(tmp_path, kind):
    """port file -> JAX load -> JAX save -> port load: bit for bit."""
    bp = _state(kind)
    port_file = tp.save_checkpoint(str(tmp_path / "port"), bp, step=3,
                                   extra={"by": "port"})
    jb, meta = jckpt.load_checkpoint(port_file)
    assert meta["step"] == 3 and meta["extra"] == {"by": "port"}
    assert jb.periodic == bp.periodic
    for name in _STATE_LEAVES:
        np.testing.assert_array_equal(np.asarray(getattr(jb, name)),
                                      getattr(bp, name).numpy())
    jax_file = jckpt.save_checkpoint(str(tmp_path / "jax"), jb, step=4,
                                     extra={"by": "jax"})
    bp2, meta = tp.load_checkpoint(jax_file, device="cpu")
    assert meta["step"] == 4 and meta["extra"] == {"by": "jax"}
    _assert_same_state(bp, bp2)


def test_resume_matches_uninterrupted(tmp_path):
    bp = _state("constant")
    trunc = tp.TruncBond(6)
    ref = bp
    for _ in range(4):
        ref = tp.bp_sweep(ref, trunc, method="qr")
    mid = tp.bp_sweep(tp.bp_sweep(bp, trunc, method="qr"), trunc,
                      method="qr")
    res, _ = tp.load_checkpoint(
        tp.save_checkpoint(str(tmp_path / "mid"), mid, step=2), device="cpu")
    for _ in range(2):
        res = tp.bp_sweep(res, trunc, method="qr")
    np.testing.assert_allclose(tp.beliefs(res).numpy(),
                               tp.beliefs(ref).numpy(), rtol=0, atol=1e-12)
    assert abs(float(tp.bethe_free_energy(res))
               - float(tp.bethe_free_energy(ref))) < 1e-12


def test_manager_async_and_retention(tmp_path):
    bp = _state("constant")
    mgr = tp.CheckpointManager(str(tmp_path / "run"), keep=2)
    for it in range(5):
        mgr.save(it, bp, extra={"iter": it})
    mgr.wait()
    assert mgr.all_steps() == [3, 4] and mgr.latest_step() == 4
    bp2, meta = mgr.restore(device="cpu")
    assert meta["step"] == 4 and meta["extra"]["iter"] == 4
    _assert_same_state(bp, bp2)
    _, meta = mgr.restore(3, device="cpu")
    assert meta["step"] == 3
    with pytest.raises(FileNotFoundError):
        tp.CheckpointManager(str(tmp_path / "empty")).restore(device="cpu")


def test_manager_save_copies_before_returning(tmp_path):
    """The state may change in place right after ``save`` returns."""
    bp = _state("constant")
    mgr = tp.CheckpointManager(str(tmp_path / "run"))
    want = bp.msg_cores.clone()
    mgr.save(0, bp)
    bp.msg_cores.zero_()
    bp2, _ = mgr.restore(device="cpu")
    assert torch.equal(bp2.msg_cores, want)


def test_manager_write_error_raises_on_wait(tmp_path):
    bp = _state("constant")
    mgr = tp.CheckpointManager(str(tmp_path / "run"))
    shutil.rmtree(mgr.directory)
    mgr.save(0, bp)
    with pytest.raises(FileNotFoundError):
        mgr.wait()
    mgr.wait()           # the error is raised once


def test_leftover_tmp_is_no_step(tmp_path):
    bp = _state("constant")
    mgr = tp.CheckpointManager(str(tmp_path / "run"), async_save=False)
    mgr.save(1, bp)
    with open(os.path.join(mgr.directory, "ckpt_5.npz.tmp"), "wb") as fh:
        fh.write(b"torn")
    assert mgr.all_steps() == [1] and mgr.latest_step() == 1


def test_load_defaults_to_the_card(tmp_path, monkeypatch):
    path = tp.save_checkpoint(str(tmp_path / "ckpt"), _state("constant"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tp.load_checkpoint(path)
