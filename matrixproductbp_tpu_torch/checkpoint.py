"""Checkpoint and resume of the BP state, with asynchronous saves.

Counterpart of ``matrixproductbp_tpu/checkpoint.py``, in its file format
(``convert.py`` holds the keys): a file written by either package loads
in the other.

* ``save_checkpoint`` / ``load_checkpoint``: one ``.npz`` a step holding
  every array of the :class:`~matrixproductbp_tpu_torch.bp.MPBP` state,
  its tables and its graph's index arrays, so that a restore needs no
  builder code.  Writes are atomic (a ``.tmp`` file, then ``os.replace``),
  so a preempted job never leaves a torn checkpoint.
* ``CheckpointManager``: a directory of step-numbered checkpoints.  A save
  copies the state to the host before it returns (so the caller may go on
  sweeping) and writes the file on a background thread; it keeps the last
  ``keep`` steps, and ``restore(step=None)`` loads the latest.
"""
from __future__ import annotations

import json
import os
import re
import threading

import numpy as np

from .bp import MPBP
from .convert import from_numpy_state, to_numpy_state

__all__ = ["save_checkpoint", "load_checkpoint", "CheckpointManager"]


def _write(path: str, arrays: dict) -> str:
    if not path.endswith(".npz"):
        path = path + ".npz"
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, **arrays)
    os.replace(tmp, path)
    return path


def save_checkpoint(path: str, bp: MPBP, step: int = 0,
                    extra: dict | None = None) -> str:
    """Write the whole BP state to one ``.npz`` file, atomically (``.npz``
    is appended when missing).  ``extra`` carries JSON-serialisable user
    metadata.  Returns the final path."""
    return _write(path, to_numpy_state(bp, step, extra))


def load_checkpoint(path: str, device=None):
    """Restore ``(bp, meta)`` from a checkpoint file onto ``device``
    (default: the CUDA card)."""
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    meta = json.loads(bytes(arrays["meta"]).decode("utf-8"))
    return from_numpy_state(arrays, meta, device=device), meta


class CheckpointManager:
    """Directory of step-numbered checkpoints with asynchronous saves and
    retention.

    >>> mgr = CheckpointManager(dir, keep=3)
    >>> for it in range(100):
    ...     bp = bp_sweep(bp, trunc)
    ...     mgr.save(it, bp)          # returns once bp is on the host
    >>> mgr.wait()                    # join the writer before exiting
    >>> bp, meta = mgr.restore()      # latest step
    """

    _PAT = re.compile(r"^ckpt_(\d+)\.npz$")

    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}.npz")

    def all_steps(self) -> list[int]:
        steps = []
        for name in os.listdir(self.directory):
            m = self._PAT.match(name)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, bp: MPBP, extra: dict | None = None) -> None:
        """Snapshot ``bp`` at ``step``.  The copy to the host happens here;
        the file write runs on a background thread when ``async_save``.  A
        failed earlier write raises here."""
        self.wait()
        arrays = to_numpy_state(bp, step, extra)

        def write():
            try:
                _write(self._path(step), arrays)
                self._retain()
            except Exception as e:  # raised by the next save() or wait()
                self._error = e

        if self.async_save:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        else:
            write()
            self._raise_pending()

    def _retain(self):
        for s in self.all_steps()[:-self.keep] if self.keep else []:
            try:
                os.remove(self._path(s))
            except FileNotFoundError:
                pass

    def _raise_pending(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def wait(self) -> None:
        """Block until the outstanding write (if any) is done; raise its
        error, if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_pending()

    def restore(self, step: int | None = None, device=None):
        """Load ``(bp, meta)`` at ``step`` (default: the latest) onto
        ``device`` (default: the CUDA card)."""
        self.wait()
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"no checkpoints in {self.directory}")
        return load_checkpoint(self._path(step), device=device)
