"""Atomic checkpoint save/restore for trees of arrays and tensors; the
counterpart of :mod:`moolib_tpu.utils.checkpoint`, file-compatible with
it (the same magic and pickle payload).

The reference keeps checkpointing at the example level: leader-only
``torch.save`` of model/optimizer/scheduler/stats, atomic tmp+``os.replace``
rename, versioned history copies, and resume that seeds
``accumulator.set_model_version`` so the checkpoint holder wins leader
election (reference: examples/vtrace/experiment.py:186-205,316-322,439-468).

Here it is a library facility. Tensor leaves are brought to the host
(``.cpu()`` of each; a card tensor costs one device-to-host copy) and the
tree is written with pickle; restore returns what was written (numpy
leaves stay numpy, torch leaves come back as CPU tensors), which callers
load onto the card themselves. A checkpoint of numpy leaves loads in
either package. Works for arbitrary trees (parameters, optimizer state,
plain dicts).
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import glob
import os
import pickle
import time
from typing import Any, List, Optional

import torch

from . import diskio, nest
from .logging import get_logger

log = get_logger("checkpoint")

__all__ = [
    "CheckpointError",
    "save_checkpoint",
    "load_checkpoint",
    "Checkpointer",
]

_MAGIC = "moolib_tpu.checkpoint.v1"


class CheckpointError(ValueError):
    """A checkpoint file exists but cannot be loaded (truncated, bit-rot,
    wrong magic, or an unpicklable payload). Subclasses ValueError so
    pre-existing ``except ValueError`` callers keep working; a MISSING
    file is not a CheckpointError (``load_checkpoint`` raises the usual
    ``FileNotFoundError`` so absence stays distinguishable from
    corruption)."""


def _to_host(tree: Any) -> Any:
    # Every tensor leaf on the host, detached; other leaves pass through
    # unchanged.
    return nest.map_structure(
        lambda x: x.detach().cpu() if isinstance(x, torch.Tensor) else x,
        tree)


def save_checkpoint(path: str, state: Any) -> None:
    """Crash-atomically write ``state`` (any picklable tree; tensors are
    brought to the host) to ``path``: tmp file + flush + fsync +
    ``os.replace`` + parent-directory fsync (see
    :mod:`moolib_tpu_torch.utils.diskio`). A SIGKILL — or an injected
    ENOSPC/EMFILE from the resource-exhaustion chaos family — at ANY
    instant leaves the previous checkpoint intact; a torn new file can
    never become the primary."""
    payload = {"magic": _MAGIC, "time": time.time(), "state": _to_host(state)}
    with diskio.atomic_writer(path) as f:
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)


def load_checkpoint(path: str) -> Any:
    """Read a checkpoint written by :func:`save_checkpoint`; returns the
    state tree as it was written.

    A file that exists but cannot be decoded — truncated write, flipped
    bits, a non-checkpoint pickle, or the wrong magic — raises the typed
    :class:`CheckpointError` rather than whatever the pickle layer threw,
    so restart paths can fall back (see :meth:`Checkpointer.load`)
    without catching bare ``Exception``. A missing file still raises
    ``FileNotFoundError``."""
    with open(path, "rb") as f:
        try:
            payload = pickle.load(f)
        except (asyncio.CancelledError, concurrent.futures.CancelledError):
            raise  # never swallow task cancellation
        except Exception as e:
            # pickle surfaces corruption as a zoo of exception types
            # (UnpicklingError, EOFError, UnicodeDecodeError, attribute
            # lookup failures...); collapse them into the typed error.
            raise CheckpointError(
                f"{path} is corrupt or truncated: {type(e).__name__}: {e}"
            ) from e
    if not (isinstance(payload, dict) and payload.get("magic") == _MAGIC):
        raise CheckpointError(f"{path} is not a moolib_tpu checkpoint")
    if "state" not in payload:
        raise CheckpointError(f"{path} carries no state payload")
    return payload["state"]


class Checkpointer:
    """Periodic checkpointing with versioned history.

    ``maybe_save`` is cheap to call every iteration; it writes at most every
    ``interval`` seconds, always to the same ``path`` (atomic), plus an extra
    immortal history copy every ``history_interval`` seconds (reference:
    examples/vtrace/experiment.py:439-468 — checkpoint + checkpoint_history).
    """

    def __init__(
        self,
        path: str,
        interval: float = 600.0,
        history_interval: Optional[float] = None,
    ):
        self.path = path
        self.interval = interval
        self.history_interval = history_interval
        self._last_save = 0.0
        self._last_history = time.time()

    def maybe_save(self, state_fn, now: Optional[float] = None) -> bool:
        """``state_fn`` is called only if a write is due (building the state
        dict can be expensive — D2H transfers)."""
        now = time.time() if now is None else now
        if now - self._last_save < self.interval:
            return False
        self.save(state_fn() if callable(state_fn) else state_fn, now=now)
        return True

    def save(self, state: Any, now: Optional[float] = None) -> None:
        now = time.time() if now is None else now
        save_checkpoint(self.path, state)
        self._last_save = now
        log.info("saved checkpoint to %s", self.path)
        if (
            self.history_interval is not None
            and now - self._last_history >= self.history_interval
        ):
            base, ext = os.path.splitext(self.path)
            hist = f"{base}-{int(now)}{ext or '.ckpt'}"
            save_checkpoint(hist, state)
            self._last_history = now
            log.info("saved history checkpoint to %s", hist)

    def history_paths(self) -> List[str]:
        """Versioned history copies for this checkpoint, newest first
        (ordered by the timestamp embedded in the filename)."""
        base, ext = os.path.splitext(self.path)
        # glob.escape: a checkpoint path containing glob metacharacters
        # ("run[1]/model.ckpt") must not silently disable the fallback.
        pattern = f"{glob.escape(base)}-*{glob.escape(ext or '.ckpt')}"
        out = []
        for p in glob.glob(pattern):
            stamp = os.path.splitext(os.path.basename(p))[0].rsplit("-", 1)[-1]
            if stamp.isdigit():
                out.append((int(stamp), p))
        return [p for _stamp, p in sorted(out, reverse=True)]

    def load(self) -> Optional[Any]:
        """Load the primary checkpoint; on corruption (typed
        :class:`CheckpointError`) fall back through the history copies,
        newest first, and only re-raise the primary's error when no valid
        copy exists anywhere. Returns None when nothing was ever saved —
        absence is a fresh start, corruption-with-no-fallback is loud."""
        primary_error: Optional[CheckpointError] = None
        if os.path.exists(self.path):
            try:
                return load_checkpoint(self.path)
            except CheckpointError as e:
                primary_error = e
                log.error("checkpoint %s unreadable (%s); trying history",
                          self.path, e)
        for hist in self.history_paths():
            try:
                state = load_checkpoint(hist)
            except CheckpointError as e:
                log.error("history checkpoint %s unreadable (%s)", hist, e)
                continue
            log.warning("recovered state from history checkpoint %s", hist)
            return state
        if primary_error is not None:
            raise primary_error
        return None
