"""Crash-atomic disk writes + the injectable disk-fault seam; a copy of
:mod:`moolib_tpu.utils.diskio`.

Durability on a preemptible host is a protocol, not a syscall: a write
that should survive SIGKILL-at-any-instant must (1) land in a temp file
in the *same directory*, (2) be flushed and ``fsync``'d so the bytes are
on the platter before anything references them, (3) be ``os.replace``'d
into place (atomic on POSIX), and (4) have the *parent directory* entry
fsync'd so the rename itself survives power loss. :func:`atomic_writer`
/ :func:`write_file_atomic` implement exactly that sequence and nothing
else; :mod:`moolib_tpu_torch.utils.checkpoint` writes through here.

The fault seam mirrors :mod:`moolib_tpu_torch.rpc.faults` one layer
down: a process-wide hook consulted at the ``open`` / ``write`` /
``fsync`` seams (zero cost when uninstalled — one attribute check),
which a seeded chaos plan can drive to inject ``ENOSPC`` / ``EMFILE``
exactly where a full disk or an fd-exhausted process would produce
them. Injected errors are real
``OSError``s with real ``errno``s: callers cannot tell them from the
organic failure, which is the point — the degradation paths under test
are the production ones.
"""

from __future__ import annotations

import os
import tempfile
from contextlib import contextmanager
from typing import Callable, Optional

__all__ = [
    "atomic_writer",
    "fsync_dir",
    "install_disk_fault_hook",
    "uninstall_disk_fault_hook",
    "write_file_atomic",
]

#: Installed hook: ``hook(op, path)`` with ``op`` in
#: ``("open", "write", "fsync")`` and ``path`` the *destination* path
#: (not the temp name). The hook either returns None (pass) or raises
#: an OSError — which propagates to the caller exactly like the organic
#: error would.
_fault_hook: Optional[Callable[[str, str], None]] = None


def install_disk_fault_hook(hook: Callable[[str, str], None]) -> None:
    """Install a process-wide disk fault hook (testing seam)."""
    global _fault_hook
    _fault_hook = hook


def uninstall_disk_fault_hook() -> None:
    global _fault_hook
    _fault_hook = None


def _consult(op: str, path: str) -> None:
    hook = _fault_hook
    if hook is not None:
        hook(op, path)


def fsync_dir(path: str) -> None:
    """fsync a directory entry so renames/creates inside it survive a
    crash. Filesystems that refuse directory fds (some FUSE/network
    mounts return EINVAL/EACCES) are tolerated — on those mounts the
    rename barrier does not exist to enforce."""
    _consult("fsync", path)
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass  # EINVAL on fsync-less mounts; the open/replace still landed
    finally:
        os.close(fd)


@contextmanager
def atomic_writer(path: str, *, fsync: bool = True):
    """Yield a binary file object; on clean exit the bytes are atomically
    (and, with ``fsync=True``, durably) visible at ``path``. On ANY
    failure — including a fault-hook injection or the process dying —
    ``path`` is untouched: readers see the previous version or nothing,
    never a torn file."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    _consult("open", path)
    fd, tmp = tempfile.mkstemp(prefix=".tmp-", dir=d)
    try:
        with os.fdopen(fd, "wb") as f:
            # mkstemp creates 0600 files; restore normal umask-governed
            # perms so other processes (eval, serving) can read the file.
            umask = os.umask(0)
            os.umask(umask)
            try:
                os.fchmod(fd, 0o666 & ~umask)
            except OSError:
                pass  # some network/FUSE mounts refuse fchmod; keep 0600
            _consult("write", path)
            yield f
            f.flush()
            if fsync:
                _consult("fsync", path)
                os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    if fsync:
        fsync_dir(d)


def write_file_atomic(path: str, data: bytes, *, fsync: bool = True) -> None:
    """Crash-atomically write ``data`` to ``path`` (see
    :func:`atomic_writer`)."""
    with atomic_writer(path, fsync=fsync) as f:
        f.write(data)
