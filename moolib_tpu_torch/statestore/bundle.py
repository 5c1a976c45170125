"""On-disk bundle format for the statestore: content-hashed, chunked,
crash-atomic versions; the counterpart of
:mod:`moolib_tpu.statestore.bundle`, byte-compatible with it (the same
magic, blob, chunks, manifest and manifest hash for a tree of numpy
leaves).

One *version* of training state is one directory::

    <root>/v000000000042/
        manifest.json     # schema below; its canonical-JSON sha256 is
                          # the version's identity in restore negotiation
        c000000.bin       # fixed-size chunks of the pickled state blob
        c000001.bin
        ...

The manifest carries a per-chunk sha256 and the blob total, so every
byte a peer serves (or a rejoiner pulls) is verifiable independently —
a flipped bit in one chunk rejects that chunk, not the holder, and the
puller refetches it from another replica.

Crash-atomicity: chunks and manifest are staged in a ``.stage-*``
sibling directory (each file fsync'd through
:mod:`moolib_tpu_torch.utils.diskio`), and the *finalize* is one atomic
``os.rename`` of the staging directory to the version name followed by
an fsync of the root — a SIGKILL or an injected ``ENOSPC`` at any
instant leaves either the complete previous state or an ignorable
``.stage-*`` leftover, never a torn version. GC mirrors it in reverse:
rename to ``.gc-*`` first, then delete — a version directory either
verifies completely or does not exist. :func:`sweep` clears leftovers
of both kinds at store open.
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle
import pickletools
import shutil
import tempfile
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..utils import diskio
from ..utils.logging import get_logger

log = get_logger("statestore")

__all__ = [
    "CHUNK_BYTES_DEFAULT",
    "MAGIC",
    "BundleCorrupt",
    "StateStoreError",
    "WriteFailed",
    "chunk_blob",
    "decode_state",
    "encode_state",
    "list_versions",
    "manifest_for",
    "manifest_hash",
    "manifest_path",
    "read_chunk",
    "read_manifest",
    "sha256_hex",
    "remove_version",
    "sweep",
    "validate_manifest",
    "verify_version",
    "version_dir",
    "write_version",
]

MAGIC = "moolib_tpu.statestore.v1"
CHUNK_BYTES_DEFAULT = 1 << 20


class StateStoreError(RuntimeError):
    """Base of the statestore's typed failures."""


class BundleCorrupt(StateStoreError):
    """A bundle (manifest or chunk) exists but fails verification —
    truncation, bit-rot, wrong magic, or a hash mismatch."""


class WriteFailed(StateStoreError):
    """Local durability failed (ENOSPC, EMFILE, permission...). The
    underlying OSError rides as ``__cause__``; the store stays usable
    (degraded) and the version may still be durable on replicas."""


# -- state blob ---------------------------------------------------------------


def _to_host(tree: Any) -> Any:
    """The tree the reference pickles for the same state: what
    ``jax.device_get`` gives back. Dicts are rebuilt with their keys
    sorted, lists, tuples and namedtuples keep their type, numpy scalars
    become 0-d arrays, tensors are detached onto the CPU (as the port's
    ``Checkpointer`` writes them), and every other leaf (numpy arrays,
    Python numbers, strings, None) passes through as the same object, so
    pickle's memo sees what it sees in the reference."""
    if isinstance(tree, dict):
        return {k: _to_host(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        items = [_to_host(x) for x in tree]
        if isinstance(tree, tuple) and hasattr(tree, "_fields"):
            return type(tree)(*items)
        return type(tree)(items)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, np.generic):
        return np.asarray(tree)
    return tree


def encode_state(state: Any) -> bytes:
    """Pickle ``state`` (numpy or tensor leaves; card tensors are copied
    to the host) into the bundle blob."""
    payload = {"magic": MAGIC, "state": _to_host(state)}
    return pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL)


def _missing_dtypes(blob: bytes, module: str) -> List[str]:
    """The names the blob imports from ``module`` (the dtypes a
    reference bundle of ``ml_dtypes`` arrays needs), read off the pickle
    opcodes without unpickling anything."""
    strings, names = [], []
    try:
        for op, arg, _pos in pickletools.genops(blob):
            if op.name in ("GLOBAL", "INST") and isinstance(arg, str):
                mod, _, attr = arg.partition(" ")
                if mod == module:
                    names.append(attr)
            elif op.name == "STACK_GLOBAL" and len(strings) >= 2:
                if strings[-2] == module:
                    names.append(strings[-1])
            if isinstance(arg, str):
                strings.append(arg)
    except Exception:  # a torn blob: name what was read so far
        pass
    return sorted(set(names))


def decode_state(blob: bytes) -> Any:
    """Inverse of :func:`encode_state`; raises :class:`BundleCorrupt`
    on anything that is not a complete, well-formed state blob. A blob
    whose leaves need a module this process lacks (a reference bundle of
    ``ml_dtypes`` bfloat16 arrays where ``ml_dtypes`` is not installed)
    raises :class:`BundleCorrupt` naming the module and its dtypes;
    nothing is cast."""
    try:
        payload = pickle.loads(blob)
    except ImportError as e:
        module = e.name or "?"
        raise BundleCorrupt(
            f"state blob needs module {module!r}, which is not importable "
            f"here (dtypes {_missing_dtypes(blob, module)}): {e}"
        ) from e
    except Exception as e:  # pickle's corruption-exception zoo
        raise BundleCorrupt(
            f"state blob undecodable: {type(e).__name__}: {e}"
        ) from e
    if not (isinstance(payload, dict) and payload.get("magic") == MAGIC
            and "state" in payload):
        raise BundleCorrupt("state blob is not a statestore payload")
    return payload["state"]


def chunk_blob(blob: bytes, chunk_bytes: int = CHUNK_BYTES_DEFAULT
               ) -> List[bytes]:
    if chunk_bytes < 1:
        raise ValueError(f"chunk_bytes must be >= 1, got {chunk_bytes!r}")
    if not blob:
        return [b""]
    return [blob[i:i + chunk_bytes]
            for i in range(0, len(blob), chunk_bytes)]


# -- manifest -----------------------------------------------------------------


def sha256_hex(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


_sha256 = sha256_hex


def manifest_for(version: int, chunks: List[bytes],
                 meta: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Build the manifest describing ``chunks``. Deliberately carries no
    wall-clock stamp: two peers bundling the same state at the same
    version produce the same manifest hash."""
    return {
        "magic": MAGIC,
        "version": int(version),
        "total_bytes": sum(len(c) for c in chunks),
        "chunks": [
            {"i": i, "size": len(c), "sha256": _sha256(c)}
            for i, c in enumerate(chunks)
        ],
        "meta": dict(meta or {}),
    }


def manifest_hash(manifest: Dict[str, Any]) -> str:
    """The version's identity: sha256 of the canonical (sorted-key,
    tight-separator) JSON encoding."""
    blob = json.dumps(manifest, sort_keys=True,
                      separators=(",", ":")).encode()
    return _sha256(blob)


def validate_manifest(obj: Any) -> Dict[str, Any]:
    """Strict structural validation; returns ``obj`` or raises
    :class:`BundleCorrupt`. Checked on every load AND on every manifest
    that arrives over the wire — a malformed offer must fail at the
    door, not corrupt a staging area."""
    if not isinstance(obj, dict) or obj.get("magic") != MAGIC:
        raise BundleCorrupt("manifest missing statestore magic")
    if set(obj) != {"magic", "version", "total_bytes", "chunks", "meta"}:
        raise BundleCorrupt(f"manifest has wrong keys: {sorted(obj)}")
    if not isinstance(obj["version"], int) or obj["version"] < 0:
        raise BundleCorrupt(f"bad manifest version: {obj['version']!r}")
    if not isinstance(obj["meta"], dict):
        raise BundleCorrupt("manifest meta must be a dict")
    chunks = obj["chunks"]
    if not isinstance(chunks, list) or not chunks:
        raise BundleCorrupt("manifest must list at least one chunk")
    total = 0
    for i, c in enumerate(chunks):
        if not (isinstance(c, dict)
                and set(c) == {"i", "size", "sha256"}
                and c["i"] == i
                and isinstance(c["size"], int) and c["size"] >= 0
                and isinstance(c["sha256"], str)
                and len(c["sha256"]) == 64):
            raise BundleCorrupt(f"bad chunk record at index {i}: {c!r}")
        total += c["size"]
    if total != obj["total_bytes"]:
        raise BundleCorrupt(
            f"chunk sizes sum to {total}, manifest says "
            f"{obj['total_bytes']}"
        )
    return obj


# -- disk layout --------------------------------------------------------------


def version_dir(root: str, version: int) -> str:
    return os.path.join(root, f"v{int(version):012d}")


def manifest_path(root: str, version: int) -> str:
    return os.path.join(version_dir(root, version), "manifest.json")


def _chunk_name(i: int) -> str:
    return f"c{int(i):06d}.bin"


def list_versions(root: str) -> List[int]:
    """Committed versions (a ``v*`` directory containing a manifest),
    ascending. ``.stage-*`` / ``.gc-*`` leftovers are invisible."""
    out = []
    try:
        names = os.listdir(root)
    except FileNotFoundError:
        return []
    for name in names:
        if name.startswith("v") and name[1:].isdigit():
            if os.path.exists(os.path.join(root, name, "manifest.json")):
                out.append(int(name[1:]))
    return sorted(out)


def write_version(root: str, version: int, manifest: Dict[str, Any],
                  chunks: List[bytes]) -> None:
    """Crash-atomically persist a version: stage, fsync, one rename,
    root fsync. Raises the underlying ``OSError`` on any write failure
    (the staging directory is cleaned up best-effort — :func:`sweep`
    catches what a crash leaves). Raises ``FileExistsError`` if the
    version is already committed (versions are immutable)."""
    final = version_dir(root, version)
    if os.path.exists(final):
        raise FileExistsError(f"version {version} already committed")
    os.makedirs(root, exist_ok=True)
    stage = tempfile.mkdtemp(prefix=f".stage-v{int(version):012d}-",
                             dir=root)
    try:
        for i, c in enumerate(chunks):
            diskio.write_file_atomic(os.path.join(stage, _chunk_name(i)), c)
        blob = json.dumps(manifest, sort_keys=True, indent=1).encode()
        diskio.write_file_atomic(os.path.join(stage, "manifest.json"), blob)
        diskio.fsync_dir(stage)
        os.rename(stage, final)  # THE commit point — atomic
    except BaseException:
        shutil.rmtree(stage, ignore_errors=True)
        raise
    diskio.fsync_dir(root)


def read_manifest(root: str, version: int) -> Dict[str, Any]:
    path = manifest_path(root, version)
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except FileNotFoundError:
        raise
    except OSError as e:
        raise BundleCorrupt(f"{path} unreadable: {e}") from e
    try:
        obj = json.loads(raw)
    except ValueError as e:
        raise BundleCorrupt(f"{path} is not valid JSON: {e}") from e
    m = validate_manifest(obj)
    if m["version"] != int(version):
        raise BundleCorrupt(
            f"{path} claims version {m['version']}, directory says "
            f"{version}"
        )
    return m


def read_chunk(root: str, version: int, i: int) -> bytes:
    """Raw chunk bytes — deliberately NOT hash-checked here: holders
    serve raw bytes and *pullers* verify, so a corrupt replica is
    detected (and routed around) at the fetching side."""
    path = os.path.join(version_dir(root, version), _chunk_name(i))
    with open(path, "rb") as f:
        return f.read()


def verify_version(root: str, version: int) -> Dict[str, Any]:
    """Fully verify a committed version — manifest schema + every chunk's
    size and sha256. Returns the manifest; raises :class:`BundleCorrupt`
    (or ``FileNotFoundError`` when the version does not exist)."""
    m = read_manifest(root, version)
    for c in m["chunks"]:
        try:
            data = read_chunk(root, version, c["i"])
        except FileNotFoundError:
            raise BundleCorrupt(
                f"version {version} chunk {c['i']} is missing"
            ) from None
        except OSError as e:
            raise BundleCorrupt(
                f"version {version} chunk {c['i']} unreadable: {e}"
            ) from e
        if len(data) != c["size"] or _sha256(data) != c["sha256"]:
            raise BundleCorrupt(
                f"version {version} chunk {c['i']} fails verification "
                f"(size {len(data)} vs {c['size']})"
            )
    return m


def remove_version(root: str, version: int) -> bool:
    """GC one version, crash-atomically: rename the directory out of the
    committed namespace first (atomic — the version is *gone* the
    instant the rename lands), then delete the files. A crash mid-delete
    leaves a ``.gc-*`` leftover that :func:`sweep` clears; it can never
    leave a half-present version."""
    final = version_dir(root, version)
    trash = os.path.join(root, f".gc-v{int(version):012d}-{os.getpid()}")
    try:
        os.rename(final, trash)
    except FileNotFoundError:
        return False
    diskio.fsync_dir(root)
    shutil.rmtree(trash, ignore_errors=True)
    return True


def sweep(root: str) -> int:
    """Remove ``.stage-*`` / ``.gc-*`` leftovers a crash may have
    stranded. Run at store open; returns the number cleared."""
    n = 0
    try:
        names = os.listdir(root)
    except FileNotFoundError:
        return 0
    for name in names:
        if name.startswith(".stage-") or name.startswith(".gc-"):
            shutil.rmtree(os.path.join(root, name), ignore_errors=True)
            n += 1
    if n:
        log.info("swept %d stranded staging/gc dir(s) in %s", n, root)
    return n
