"""Checkpoint/resume.

The reference has NO checkpointing (a crash loses the run; SURVEY §5).
Here a checkpoint captures everything needed for a bit-exact restart of the
scenario phase (cf. the state the Fortran keeps in module variables):

  - prognostic ModelState (ts, ta, to, q, cap_surf)
  - the 730-slot Corrections tables
  - scalar cursor: (phase, year_index, co2)

One format: a directory ``ckpt_<step>`` holding ``state.npz`` (NumPy) and
``cursor.json``.  Each checkpoint is written under a temporary name and
renamed into place, so a crash mid-write leaves the previous complete
checkpoint as the latest one.
"""
from __future__ import annotations

import json
import os
import shutil
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..forcing import Corrections, ModelState

_STATE_FIELDS = ("ts", "ta", "to", "q", "cap_surf")
_CORR_FIELDS = ("tf", "tof", "qf")


@dataclass
class RunCursor:
    phase: str = "scenario"     # "flux" | "control" | "scenario"
    year_index: int = 0
    co2: float = 680.0


def _write(path: str, arrays: Dict[str, np.ndarray],
           cursor: RunCursor) -> None:
    """Write and fsync both files, so a rename after this publishes
    complete data."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "state.npz"), "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    with open(os.path.join(path, "cursor.json"), "w") as f:
        json.dump({"phase": cursor.phase, "year_index": cursor.year_index,
                   "co2": cursor.co2}, f)
        f.flush()
        os.fsync(f.fileno())


def save_checkpoint(path: str, state: ModelState, corr: Corrections,
                    cursor: RunCursor) -> None:
    arrays = {k: np.asarray(getattr(state, k)) for k in _STATE_FIELDS}
    arrays.update({k: np.asarray(getattr(corr, k)) for k in _CORR_FIELDS})
    _write(path, arrays, cursor)


def load_checkpoint(path: str) -> Tuple[ModelState, Corrections, RunCursor]:
    import jax.numpy as jnp
    with np.load(os.path.join(path, "state.npz")) as z:
        state = ModelState(**{k: jnp.asarray(z[k]) for k in _STATE_FIELDS})
        corr = Corrections(**{k: jnp.asarray(z[k]) for k in _CORR_FIELDS})
    with open(os.path.join(path, "cursor.json")) as f:
        c = json.load(f)
    return state, corr, RunCursor(**c)


class Checkpointer:
    """Periodic checkpoints in ``directory``, keeping the newest ``keep``."""

    def __init__(self, directory: str, every_years: int = 10, keep: int = 3):
        self.dir = directory
        self.every = max(1, every_years)
        self.keep = keep
        # host snapshot of the correction tables: corr is CONSTANT across
        # the scenario phase (learned once in spin-up, src/greb.f90:344-355)
        # and is the bulk of a checkpoint, so copy it once per corr object
        self._corr_ref = None
        self._corr_np = None

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"ckpt_{step:06d}")

    def maybe_save(self, year_index: int, state: ModelState,
                   corr: Corrections, cursor: RunCursor) -> bool:
        if (year_index + 1) % self.every != 0:
            return False
        self.save(year_index, state, corr, cursor)
        return True

    def save(self, step: int, state: ModelState, corr: Corrections,
             cursor: RunCursor) -> None:
        if corr is not self._corr_ref:   # identity, not id(): holds a ref
            self._corr_np = {k: np.asarray(getattr(corr, k))
                             for k in _CORR_FIELDS}
            self._corr_ref = corr
        arrays = {k: np.asarray(getattr(state, k)) for k in _STATE_FIELDS}
        arrays.update(self._corr_np)
        final = self._path(step)
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        _write(tmp, arrays, cursor)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        for old in self.steps()[:-self.keep]:
            shutil.rmtree(self._path(old), ignore_errors=True)

    def steps(self) -> List[int]:
        """Completed checkpoint steps, oldest first."""
        if not os.path.isdir(self.dir):
            return []
        return sorted(int(d[5:]) for d in os.listdir(self.dir)
                      if d.startswith("ckpt_") and d[5:].isdigit())

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None
                ) -> Tuple[ModelState, Corrections, RunCursor]:
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        return load_checkpoint(self._path(step))
