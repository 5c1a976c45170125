"""Binary wire serialization with out-of-band tensor framing; the
counterpart of :mod:`moolib_tpu.rpc.serial`, byte for byte.

Design parity with the reference's serialization stack
(reference: src/serialization.h:238-379 two-pass serializer;
src/memory/buffer.h:25-56 Buffer with TensorRef[] tail;
src/pythonserialization.h:43-57 tagged python union with pickle fallback;
src/transports/ipc.cc:61-98 scatter/gather frame layout).

Python-native redesign: instead of a sizing pass + write pass into one slab,
``serialize`` produces an iovec-style list of buffers (small metadata chunks
plus zero-copy memoryviews of tensor data) suitable for
``socket.sendmsg``/``writer.writelines`` scatter-gather I/O. Tensor payloads
ride out-of-band after the tagged metadata, padded to 64-byte boundaries so
receivers can alias numpy views directly over the received frame
(reference keeps the same 64-byte alignment for reconstructed tensors).

Frame layout:

    u32 MAGIC | u64 body_len | body
    body = u64 rid | u32 fid | u32 n_tensors | u64 meta_len | meta
           | pad to 64 | per tensor: u64 nbytes | pad to 64 | data | pad to 64

Metadata is a 1-byte-tagged recursive encoding covering the same type set as
the reference's ``pyTypes`` (None/bool/int/float/str/bytes/list/tuple/dict/
tensor/pickle-fallback); ndarray and torch tensor leaves encode dtype+shape
in-line and reference their payload by index.

Torch leaves: a tensor is detached, brought to the host (a CUDA tensor
costs one device-to-host copy) and made contiguous; its dtype string is
the one numpy writes for the same data, so a tensor and its numpy twin
encode to the same bytes. ``bfloat16`` travels as the dtype *name*
``"bfloat16"`` (what the reference writes for its ml_dtypes arrays) over
the int16 bits. numpy knows that name only once ``ml_dtypes`` is
imported, which the port never does, so a ``"bfloat16"`` leaf decodes
into a ``torch.bfloat16`` CPU tensor over the same bytes; every other
leaf decodes to a read-only numpy view, as in the reference.

The pad after ``meta`` is measured from the START of the body, so every
tensor payload sits at a 64-byte-aligned *body offset* regardless of the
metadata's length; receivers that place the body in a 64-byte-aligned
buffer (:func:`alloc_aligned` — the RPC frame protocol and the shm ring
lane both do) therefore get dtype-aligned zero-copy views from
``_decode_tensor`` with no copy fallback on the hot path.

Zero-copy receive contract: tensor leaves decoded by
:func:`deserialize_body` are numpy views ALIASING the receive buffer
(the TCP reassembly buffer or a shared-memory spill slot). Callers must
treat them as read-only — mutating one in place corrupts the buffer for
every other view of the same message (and, on the shm lane, memory the
sending process still owns); copy first (``np.array(x)``) to mutate.
The views keep the backing buffer alive, so holding a decoded tensor
pins the whole message body (and, on the shm lane, its spill slot).
"""

from __future__ import annotations

import pickle
import struct
import warnings
from typing import Any, List, Tuple

import numpy as np
import torch

__all__ = [
    "MAGIC",
    "HEADER",
    "alloc_aligned",
    "serialize",
    "deserialize_body",
    "frames_len",
]

MAGIC = 0x4D4C5450  # "MLTP"
HEADER = struct.Struct("<IQ")  # magic, body_len
_BODY_HEAD = struct.Struct("<QIIQ")  # rid, fid, n_tensors, meta_len
_ALIGN = 64

_T_NONE = 0
_T_TRUE = 1
_T_FALSE = 2
_T_INT = 3
_T_FLOAT = 4
_T_STR = 5
_T_BYTES = 6
_T_LIST = 7
_T_TUPLE = 8
_T_DICT = 9
_T_TENSOR = 10
_T_PICKLED = 11
_T_BIGINT = 12

_I64_MIN, _I64_MAX = -(2**63), 2**63 - 1


_BF16 = "bfloat16"


def _host_array(t: torch.Tensor) -> Tuple[np.ndarray, bytes]:
    """A torch leaf as (contiguous host array, wire dtype string)."""
    t = t.detach()
    if t.device.type != "cpu":
        t = t.cpu()
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), _BF16.encode()
    arr = t.numpy()
    return arr, arr.dtype.str.encode()


def _tensor_leaf(arr: np.ndarray, dt: bytes, meta: bytearray,
                 tensors: List[np.ndarray]) -> None:
    meta.append(_T_TENSOR)
    meta += struct.pack("<IB", len(tensors), arr.ndim)
    for d in arr.shape:
        meta += struct.pack("<Q", d)
    meta += struct.pack("<B", len(dt))
    meta += dt
    tensors.append(arr)


def _encode(obj: Any, meta: bytearray, tensors: List[np.ndarray]) -> None:
    if obj is None:
        meta.append(_T_NONE)
    elif obj is True:
        meta.append(_T_TRUE)
    elif obj is False:
        meta.append(_T_FALSE)
    elif type(obj) is int:
        if _I64_MIN <= obj <= _I64_MAX:
            meta.append(_T_INT)
            meta += struct.pack("<q", obj)
        else:
            enc = str(obj).encode()
            meta.append(_T_BIGINT)
            meta += struct.pack("<I", len(enc))
            meta += enc
    elif type(obj) is float:
        meta.append(_T_FLOAT)
        meta += struct.pack("<d", obj)
    elif type(obj) is str:
        enc = obj.encode()
        meta.append(_T_STR)
        meta += struct.pack("<I", len(enc))
        meta += enc
    elif type(obj) in (bytes, bytearray, memoryview):
        b = bytes(obj) if not isinstance(obj, bytes) else obj
        meta.append(_T_BYTES)
        meta += struct.pack("<Q", len(b))
        meta += b
    elif type(obj) is list:
        meta.append(_T_LIST)
        meta += struct.pack("<I", len(obj))
        for x in obj:
            _encode(x, meta, tensors)
    elif type(obj) is tuple:
        meta.append(_T_TUPLE)
        meta += struct.pack("<I", len(obj))
        for x in obj:
            _encode(x, meta, tensors)
    elif type(obj) is dict:
        meta.append(_T_DICT)
        meta += struct.pack("<I", len(obj))
        for k, v in obj.items():
            _encode(k, meta, tensors)
            _encode(v, meta, tensors)
    elif isinstance(obj, torch.Tensor):
        _tensor_leaf(*_host_array(obj), meta, tensors)
    elif isinstance(obj, (np.ndarray, np.generic)):
        arr = np.asarray(obj)
        if not arr.flags.c_contiguous:
            arr = np.ascontiguousarray(arr)
        # .str loses extension types (bfloat16 -> '<V2'); use the registered
        # name for those so np.dtype() round-trips on the receiver.
        dt = (
            arr.dtype.str if "V" not in arr.dtype.str else arr.dtype.name
        ).encode()
        _tensor_leaf(arr, dt, meta, tensors)
    else:
        blob = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        meta.append(_T_PICKLED)
        meta += struct.pack("<Q", len(blob))
        meta += blob


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: memoryview):
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> memoryview:
        p = self.pos
        if p + n > len(self.buf):
            raise ValueError("truncated message")
        self.pos = p + n
        return self.buf[p : p + n]

    def unpack(self, st: struct.Struct):
        return st.unpack(self.take(st.size))


_Q = struct.Struct("<Q")
_I = struct.Struct("<I")
_q = struct.Struct("<q")
_d = struct.Struct("<d")
_IB = struct.Struct("<IB")
_B = struct.Struct("<B")


def _decode(r: _Reader, tensors: List[np.ndarray]) -> Any:
    tag = r.take(1)[0]
    if tag == _T_NONE:
        return None
    if tag == _T_TRUE:
        return True
    if tag == _T_FALSE:
        return False
    if tag == _T_INT:
        return r.unpack(_q)[0]
    if tag == _T_FLOAT:
        return r.unpack(_d)[0]
    if tag == _T_STR:
        (n,) = r.unpack(_I)
        return bytes(r.take(n)).decode()
    if tag == _T_BYTES:
        (n,) = r.unpack(_Q)
        return bytes(r.take(n))
    if tag == _T_LIST:
        (n,) = r.unpack(_I)
        return [_decode(r, tensors) for _ in range(n)]
    if tag == _T_TUPLE:
        (n,) = r.unpack(_I)
        return tuple(_decode(r, tensors) for _ in range(n))
    if tag == _T_DICT:
        (n,) = r.unpack(_I)
        out = {}
        for _ in range(n):
            k = _decode(r, tensors)
            out[k] = _decode(r, tensors)
        return out
    if tag == _T_TENSOR:
        return _decode_tensor(r, tensors)
    if tag == _T_BIGINT:
        (n,) = r.unpack(_I)
        return int(bytes(r.take(n)).decode())
    if tag == _T_PICKLED:
        return _decode_pickled(r)
    raise ValueError(f"unknown wire tag {tag}")


def _decode_tensor(r: _Reader, tensors: List[np.ndarray]) -> Any:
    """Shared by the pure-Python decoder and the native decoder's fallback:
    one place owns the tensor wire layout.

    Returns a zero-copy view aliasing the receive buffer whenever the
    payload's address is aligned for the target dtype (the frame layout
    64-byte-aligns every tensor's *body offset*, so with an aligned
    receive buffer — :func:`alloc_aligned` — this is the only path
    taken); an unaligned payload (a caller decoding out of an arbitrary
    bytes offset) falls back to one copy so the returned array is always
    dtype-aligned. Callers must not mutate the view (see the module
    docstring's zero-copy receive contract). A ``"bfloat16"`` leaf
    becomes a ``torch.bfloat16`` tensor over the same bytes."""
    idx, ndim = r.unpack(_IB)
    shape = tuple(r.unpack(_Q)[0] for _ in range(ndim))
    (dtlen,) = r.unpack(_B)
    name = bytes(r.take(dtlen)).decode()
    raw = tensors[idx]
    if name == _BF16:
        return _bf16_tensor(raw, shape)
    dt = np.dtype(name)
    if dt.itemsize > 1 and raw.ctypes.data % dt.alignment:
        raw = raw.copy()  # unaligned source: one copy beats an unaligned
        # view (compiled consumers fault or crawl on unaligned loads)
    return raw.view(dt).reshape(shape)


def _bf16_tensor(raw: np.ndarray, shape: Tuple[int, ...]) -> torch.Tensor:
    if raw.ctypes.data % 2:
        raw = raw.copy()
    bits = raw.view(np.int16).reshape(shape)
    if bits.flags.writeable:
        t = torch.from_numpy(bits)
    else:
        # A read-only receive buffer (decoding out of ``bytes``): torch
        # warns that it cannot mark the tensor read-only; the zero-copy
        # contract above already forbids writing to it.
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            t = torch.from_numpy(bits)
    return t.view(torch.bfloat16)


def _decode_pickled(r: _Reader) -> Any:
    (n,) = r.unpack(_Q)
    return pickle.loads(r.take(n))


_PAD = b"\x00" * _ALIGN


def alloc_aligned(nbytes: int, align: int = _ALIGN) -> np.ndarray:
    """A zeroed-length-free uint8 buffer of ``nbytes`` whose data pointer
    is ``align``-byte aligned — the receive-buffer allocator for every
    lane (TCP frame reassembly, shm inline/chunk staging), pairing with
    the frame layout's body-offset alignment so ``_decode_tensor`` can
    return aligned views instead of copies."""
    buf = np.empty(nbytes + align, np.uint8)
    off = (-buf.ctypes.data) % align
    return buf[off:off + nbytes]


def _get_native():
    """The C++ serializer hot path (moolib_tpu_torch/native/_native.cpp),
    or None.

    Imported lazily so serial.py stays importable in stripped environments;
    the native module implements the identical wire format and defers
    tensor/pickle handling back to the pure-Python tag writers here.
    """
    global _native
    if _native is _UNSET:
        try:
            from ..native import get_native

            _native = get_native()
        except Exception:
            _native = None
    return _native


_UNSET = object()
_native = _UNSET


def _encode_toplevel(obj: Any) -> Tuple[bytes, List[np.ndarray]]:
    native = _get_native()
    tensors: List[np.ndarray] = []
    if native is None:
        meta = bytearray()
        _encode(obj, meta, tensors)
        return bytes(meta), tensors

    def fallback(x) -> bytes:
        chunk = bytearray()
        _encode(x, chunk, tensors)  # tensor/pickle/np-scalar tags only
        return bytes(chunk)

    return native.encode(obj, fallback), tensors


def _decode_toplevel(meta_view: memoryview, tensors: List[np.ndarray]) -> Any:
    native = _get_native()
    if native is None:
        return _decode(_Reader(meta_view), tensors)

    def fallback(tag: int, pos: int):
        r = _Reader(meta_view)
        r.pos = pos
        if tag == _T_TENSOR:
            return _decode_tensor(r, tensors), r.pos
        if tag == _T_PICKLED:
            return _decode_pickled(r), r.pos
        raise ValueError(f"unexpected fallback tag {tag}")

    obj, _end = native.decode(meta_view, fallback)
    return obj


def serialize(rid: int, fid: int, obj: Any) -> List[Any]:
    """Encode a message into an iovec list (bytes + zero-copy memoryviews).

    The first element contains the frame header; tensor data buffers are
    memoryviews over the caller's arrays (no copy) — the caller must keep
    them alive until the write completes (same contract as the reference's
    SharedBufferHandle send path).
    """
    meta, tensors = _encode_toplevel(obj)

    tensor_parts: List[Any] = []
    tensor_bytes = 0
    for arr in tensors:
        nb = arr.nbytes
        head = _Q.pack(nb)
        pad1 = -(len(head)) % _ALIGN
        tensor_parts.append(head + _PAD[:pad1])
        if nb == 0:
            pass  # nothing to send for empty tensors
        elif arr.ndim == 0:
            tensor_parts.append(arr.tobytes())
        else:
            # view as uint8 first: extension dtypes (bfloat16 etc.) don't
            # support the buffer protocol directly.
            tensor_parts.append(memoryview(arr.reshape(-1).view(np.uint8)))
        pad2 = -nb % _ALIGN
        if pad2:
            tensor_parts.append(_PAD[:pad2])
        tensor_bytes += len(head) + pad1 + nb + pad2

    body_head = _BODY_HEAD.pack(rid, fid, len(tensors), len(meta))
    # Pad meta so the tensor section starts at a 64-byte-aligned BODY
    # offset (body_head is 24 bytes, each tensor block is internally
    # 64-padded): with an aligned receive buffer every tensor payload
    # lands dtype-aligned and decodes as a view, never a copy.
    meta_pad = -(_BODY_HEAD.size + len(meta)) % _ALIGN
    body_len = len(body_head) + len(meta) + meta_pad + tensor_bytes
    out: List[Any] = [
        HEADER.pack(MAGIC, body_len) + body_head + meta + _PAD[:meta_pad]
    ]
    out.extend(tensor_parts)
    return out


def frames_len(frames: List[Any]) -> int:
    return sum(len(f) for f in frames)


def deserialize_body(body: memoryview, *,
                     copy_tensors: bool = False) -> Tuple[int, int, Any]:
    """Decode a message body (everything after the 12-byte frame header).

    Tensor leaves are numpy views aliasing ``body`` (zero-copy): valid as
    long as the receive buffer is alive, which the caller guarantees by
    handing ownership of ``body``'s base to the decoded message consumer
    — and the consumer must not mutate them (module docstring contract).
    ``copy_tensors=True`` forces one copy per tensor payload instead (the
    pre-zero-copy behavior) — kept for consumers that need detached
    arrays and as the serial bench's A/B control arm.
    """
    r = _Reader(memoryview(body))
    rid, fid, n_tensors, meta_len = r.unpack(_BODY_HEAD)
    meta_view = r.take(meta_len)
    r.take(-(_BODY_HEAD.size + meta_len) % _ALIGN)  # meta alignment pad
    # Tensor payload section begins after meta; parse it first so decode can
    # reference tensors by index.
    tensors: List[np.ndarray] = []
    for _ in range(n_tensors):
        (nb,) = r.unpack(_Q)
        r.take(-_Q.size % _ALIGN)
        data = r.take(nb)
        r.take(-nb % _ALIGN)
        arr = np.frombuffer(data, dtype=np.uint8)
        tensors.append(arr.copy() if copy_tensors else arr)
    obj = _decode_toplevel(meta_view, tensors)
    return rid, fid, obj
