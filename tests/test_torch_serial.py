"""Port parity: the wire codec of moolib_tpu_torch against moolib_tpu.

The same message must give byte-identical frames in both packages (the
wire is one wire), the port's native and pure-Python codecs must agree,
torch leaves must encode as their numpy twins, and bfloat16 must cross
between the packages bit-exactly, also in an interpreter that never
imported ml_dtypes. Tolerance: exact (bytes and bits).
"""

import json
import subprocess
import sys
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

from moolib_tpu.rpc import serial as ref_serial
from moolib_tpu_torch.rpc import serial as port_serial

REPO_ROOT = Path(__file__).resolve().parent.parent


class Pickled:
    """A module-level class, so both packages pickle it identically."""

    def __init__(self, a, b):
        self.a, self.b = a, b

    def __eq__(self, other):
        return isinstance(other, Pickled) and (self.a, self.b) == (
            other.a, other.b)


def _nests():
    rng = np.random.default_rng(0)
    return {
        "scalars": [None, True, False, 0, -5, 3.5, "héllo", "", b"",
                    2**40, -(2**63)],
        "big ints": (2**100, -(2**100), 2**63),
        "bytes": {"b": b"\x00\x01bytes", "ba": bytearray(b"zz")},
        "nested dicts": {"a": {"b": {"c": [1, {"d": (2, None)}]}}, 3: "x"},
        "tuples": ((1, (2, (3, ()))), [()], (None,)),
        "numpy leaves": {
            "f32": rng.standard_normal((4, 5)).astype(np.float32),
            "f64": rng.standard_normal(7),
            "i64": rng.integers(-9, 9, (2, 3)),
            "u8": rng.integers(0, 255, (3, 2, 2)).astype(np.uint8),
            "bool": rng.integers(0, 2, 5).astype(bool),
            "scalar0d": np.float32(3.25),
            "empty": np.zeros((0, 3), np.float32),
            "strided": rng.standard_normal((6, 8))[::2, 1::3],
        },
        "pickled object": {"obj": Pickled(1, "two"), "set": {1, 2}},
    }


def _frame(mod, obj, rid=7, fid=1234):
    return b"".join(bytes(f) for f in mod.serialize(rid, fid, obj))


def _decode(mod, blob):
    body = mod.alloc_aligned(len(blob) - mod.HEADER.size)
    body[:] = np.frombuffer(blob, np.uint8)[mod.HEADER.size:]
    return mod.deserialize_body(memoryview(body))


def _same(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (np.asarray(a).dtype == np.asarray(b).dtype
                and np.array_equal(np.asarray(a), np.asarray(b)))
    if isinstance(a, dict):
        return (type(a) is type(b) and a.keys() == b.keys()
                and all(_same(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    if isinstance(b, bytearray):  # the wire's bytes type
        return type(a) is bytes and a == bytes(b)
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("name", sorted(_nests()))
def test_frames_are_byte_identical_to_the_reference(name):
    obj = _nests()[name]
    blob = _frame(port_serial, obj)
    assert blob == _frame(ref_serial, obj)
    # Each package decodes the other's frame into the same message.
    for dec in (port_serial, ref_serial):
        rid, fid, out = _decode(dec, blob)
        assert (rid, fid) == (7, 1234)
        assert _same(out, obj), (dec.__name__, out)


@pytest.mark.parametrize("name", sorted(_nests()))
def test_native_and_pure_python_codecs_agree(name, monkeypatch):
    if port_serial._get_native() is None:
        pytest.fail("the port's native codec did not build here (g++)")
    obj = _nests()[name]
    native = _frame(port_serial, obj)
    native_out = _decode(port_serial, native)
    monkeypatch.setattr(port_serial, "_native", None)
    assert port_serial._get_native() is None
    pure = _frame(port_serial, obj)
    assert pure == native
    assert _same(_decode(port_serial, pure)[2], native_out[2])


@pytest.mark.parametrize("dtype", [
    torch.float32, torch.float64, torch.float16, torch.int64, torch.int32,
    torch.int16, torch.int8, torch.uint8, torch.bool, torch.complex64,
])
def test_torch_tensor_encodes_as_its_numpy_twin(dtype):
    g = torch.Generator().manual_seed(0)
    t = (torch.randn(3, 4, 5, generator=g) * 50).to(dtype)
    for leaf in (t, t[:, 1::2, :3], t[0, 0, 0], t[:0]):
        blob = _frame(port_serial, {"x": leaf, "y": [leaf]})
        twin = leaf.numpy().copy()
        assert blob == _frame(ref_serial, {"x": twin, "y": [twin]})
        out = _decode(port_serial, blob)[2]
        assert isinstance(out["x"], np.ndarray)
        assert out["x"].dtype == twin.dtype
        np.testing.assert_array_equal(out["x"], twin)


def test_torch_tensor_with_grad_is_detached():
    t = torch.ones(4, requires_grad=True) * 3
    out = _decode(port_serial, _frame(port_serial, t))[2]
    np.testing.assert_array_equal(out, np.full(4, 3, np.float32))


def test_bfloat16_crosses_between_the_packages_bit_exactly():
    g = torch.Generator().manual_seed(0)
    t = torch.randn(5, 7, generator=g).to(torch.bfloat16)
    bits = t.view(torch.int16).numpy()
    # Port -> reference: the reference reads an ml_dtypes bfloat16 array.
    blob = _frame(port_serial, {"w": t})
    ref_out = _decode(ref_serial, blob)[2]["w"]
    assert ref_out.dtype == np.dtype(ml_dtypes.bfloat16)
    np.testing.assert_array_equal(ref_out.view(np.int16), bits)
    # And both packages write the same frame for the same bits.
    assert blob == _frame(ref_serial, {"w": bits.view(ml_dtypes.bfloat16)})
    # Reference -> port: a torch.bfloat16 CPU tensor with equal bits.
    port_out = _decode(port_serial, blob)[2]["w"]
    assert isinstance(port_out, torch.Tensor)
    assert port_out.dtype == torch.bfloat16 and port_out.device.type == "cpu"
    np.testing.assert_array_equal(port_out.view(torch.int16).numpy(), bits)
    # Decoding out of read-only bytes works too (no zero-copy buffer).
    body = memoryview(blob)[port_serial.HEADER.size:]
    out = port_serial.deserialize_body(body)[2]["w"]
    np.testing.assert_array_equal(out.view(torch.int16).numpy(), bits)


_NO_ML_DTYPES = r"""
import json, sys
import numpy as np
import torch
from moolib_tpu_torch.rpc import serial
bits = np.arange(-6, 6, dtype=np.int16).reshape(3, 4) * 1031
frames = serial.serialize(1, 2, {"w": torch.from_numpy(bits.copy()).view(
    torch.bfloat16)})
blob = b"".join(bytes(f) for f in frames)
out = serial.deserialize_body(memoryview(blob)[serial.HEADER.size:])[2]["w"]
try:
    np.dtype("bfloat16")
    np_knows_bf16 = True
except TypeError:
    np_knows_bf16 = False
print(json.dumps({
    "dtype": str(out.dtype),
    "equal": bool((out.view(torch.int16).numpy() == bits).all()),
    "ml_dtypes": "ml_dtypes" in sys.modules,
    "np_knows_bf16": np_knows_bf16,
}))
"""


def test_bfloat16_decodes_without_ml_dtypes_in_a_fresh_interpreter():
    proc = subprocess.run(
        [sys.executable, "-c", _NO_ML_DTYPES], cwd=str(REPO_ROOT),
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got == {"dtype": "torch.bfloat16", "equal": True,
                   "ml_dtypes": False, "np_knows_bf16": False}


def test_decode_is_zero_copy_and_aligned():
    rng = np.random.default_rng(1)
    for meta_junk in ("", "x", "abcdefghijk"):
        obj = {"pad": meta_junk, "f64": rng.standard_normal(1 << 10),
               "bf": torch.ones(1 << 10, dtype=torch.bfloat16)}
        blob = _frame(port_serial, obj)
        body = port_serial.alloc_aligned(len(blob) - port_serial.HEADER.size)
        body[:] = np.frombuffer(blob, np.uint8)[port_serial.HEADER.size:]
        out = port_serial.deserialize_body(memoryview(body))[2]
        assert np.shares_memory(out["f64"], body) and out["f64"].flags.aligned
        assert np.shares_memory(out["bf"].view(torch.int16).numpy(), body)


def test_truncated_frame_raises():
    blob = _frame(port_serial, {"x": torch.arange(10)})
    with pytest.raises(ValueError):
        port_serial.deserialize_body(
            memoryview(blob[port_serial.HEADER.size:-8]))
