"""The port's Batcher against the reference's: each case feeds both the
same numpy stream and compares what comes out bit for bit; the behaviour
cases (blocking, timeouts, close, wait_below, await, flush, counters) run
on both, parametrised ref/port."""

import asyncio
import threading
import time

import numpy as np
import pytest
import torch

from moolib_tpu.ops.batcher import Batcher as RefBatcher
from moolib_tpu.telemetry import global_telemetry as ref_telemetry
from moolib_tpu_torch.ops import Batcher as PortBatcher
from moolib_tpu_torch.telemetry import global_telemetry as port_telemetry

PKGS = {"ref": (RefBatcher, ref_telemetry),
        "port": (PortBatcher, port_telemetry)}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return request.param


def _host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(a, b):
    """Equal trees: same structure, same dtypes, shapes and bytes."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        a, b = _host(a), _host(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def _item(rng, shape=(3,)):
    return {"obs": rng.standard_normal(shape).astype(np.float32),
            "aux": (rng.integers(0, 5, shape).astype(np.int64),)}


def _unroll(rng, T, b):
    return {"obs": rng.integers(0, 255, (T, b, 2, 2)).astype(np.uint8),
            "done": rng.random((T, b)) < 0.3,
            "core_state": (rng.standard_normal((b, 5)).astype(np.float32),
                           rng.standard_normal((b, 5)).astype(np.float32))}


def _drain(b):
    out = []
    while not b.empty():
        out.append(b.get(timeout=1))
    return out


def _both(**kw):
    return RefBatcher(**kw), PortBatcher(**kw)


def test_stack_batches_equal_the_reference():
    rng = np.random.default_rng(0)
    ref, port = _both(batch_size=4)
    items = [_item(rng) for _ in range(14)]
    for it in items:
        ref.stack(it)
        port.stack(it)
    r, p = _drain(ref), _drain(port)
    assert len(r) == len(p) == 3
    for x, y in zip(r, p):
        _same(x, y)
    assert ref.flush() and port.flush()  # the 2 left over, a short batch
    _same(ref.get(timeout=1), port.get(timeout=1))


@pytest.mark.parametrize("sizes", [[3, 7, 2, 9, 11, 1, 5], [8, 8], [20, 1]])
def test_cat_split_and_carry_equal_the_reference(sizes):
    rng = np.random.default_rng(len(sizes))
    ref, port = _both(batch_size=8)
    for n in sizes:
        chunk = _item(rng, (n, 2))
        ref.cat(chunk)
        port.cat(chunk)
        r, p = _drain(ref), _drain(port)
        assert len(r) == len(p)
        for x, y in zip(r, p):
            assert _host(y["obs"]).shape[0] == 8
            _same(x, y)
    assert ref.flush() == port.flush()
    _same(_drain(ref), _drain(port))


def test_cat_per_key_dims_equal_the_reference():
    """Learn unrolls: [T, B, ...] leaves cat on dim 1, core_state's [B, ...]
    on dim 0, overflow carried on each key's own axis."""
    rng = np.random.default_rng(2)
    ref, port = _both(batch_size=4, dim=1, dims={"core_state": 0})
    got_r, got_p = [], []
    for b in (3, 3, 3, 2, 5):
        u = _unroll(rng, 5, b)
        ref.cat(u)
        port.cat(u)
        got_r += _drain(ref)
        got_p += _drain(port)
    assert len(got_r) == len(got_p) == 4
    for x, y in zip(got_r, got_p):
        _same(x, y)


def test_stack_per_key_dims_equal_the_reference():
    rng = np.random.default_rng(3)
    ref, port = _both(batch_size=3, dim=1, dims={"core_state": 0})
    for _ in range(3):
        it = {"obs": rng.standard_normal((4, 2)).astype(np.float32),
              "core_state": (rng.standard_normal(5).astype(np.float32),)}
        ref.stack(it)
        port.stack(it)
    r, p = ref.get(timeout=1), port.get(timeout=1)
    assert _host(p["obs"]).shape == (4, 3, 2)
    _same(r, p)


def test_counters_equal_the_reference():
    """batcher_batches_total, batcher_rows_total and the fill histogram's
    count after the same stream (each package's global telemetry)."""
    rng = np.random.default_rng(4)
    name = "torch-parity-counters"
    ref, port = (cls(batch_size=4, name=name) for cls in
                 (RefBatcher, PortBatcher))
    for n in (3, 3, 3, 3, 6):
        chunk = _item(rng, (n,))
        ref.cat(chunk)
        port.cat(chunk)
    ref.flush()
    port.flush()
    vals = []
    for _, tel in PKGS.values():
        reg = tel().registry
        vals.append((
            reg.value("batcher_batches_total", batcher=name),
            reg.value("batcher_rows_total", batcher=name),
            reg.histogram("batcher_fill_seconds", batcher=name).count))
    assert vals[0] == vals[1] == (5.0, 18.0, 5)


def test_structure_and_axis_errors(pkg):
    cls, _ = PKGS[pkg]
    b = cls(batch_size=8)
    b.cat({"x": np.zeros((2, 3))})
    with pytest.raises(ValueError, match="structure mismatch"):
        b.cat({"y": np.zeros((2, 3))})
    with pytest.raises(ValueError, match="inconsistent batch axis"):
        b.cat({"x": np.zeros((2, 3)), "z": np.zeros((3, 3))})
    with pytest.raises(ValueError):
        cls(batch_size=0)


def test_get_blocks_until_a_producer_fills(pkg):
    cls, _ = PKGS[pkg]
    b = cls(batch_size=2)
    result = {}
    t = threading.Thread(target=lambda: result.setdefault(
        "batch", b.get(timeout=5)))
    t.start()
    rng = np.random.default_rng(5)
    b.stack(_item(rng))
    b.stack(_item(rng))
    t.join(timeout=5)
    assert not t.is_alive()
    assert _host(result["batch"]["obs"]).shape == (2, 3)


def test_get_timeout_and_close(pkg):
    cls, _ = PKGS[pkg]
    b = cls(batch_size=2)
    with pytest.raises(TimeoutError):
        b.get(timeout=0.05)
    b.close()
    with pytest.raises(RuntimeError, match="closed"):
        b.get(timeout=1)
    with pytest.raises(RuntimeError, match="closed"):
        b.stack({"x": np.zeros(1)})


def test_wait_below_wakes_on_consumption(pkg):
    cls, _ = PKGS[pkg]
    b = cls(batch_size=1)
    for i in range(2):
        b.stack({"x": np.full(2, float(i))})
    assert b.ready() == b.size() == 2
    assert b.wait_below(2, timeout=0.05) is False
    threading.Timer(0.1, lambda: b.get(timeout=1)).start()
    t0 = time.monotonic()
    assert b.wait_below(2, timeout=5) is True
    assert time.monotonic() - t0 < 4
    assert b.ready() == 1
    b.close()
    assert b.wait_below(0, timeout=1) is True  # closed: nothing to wait for


def test_await_yields_batches_and_size(pkg):
    cls, _ = PKGS[pkg]
    b = cls(batch_size=2)

    async def consume():
        def produce():
            for i in range(4):
                b.stack({"x": np.full(3, float(i))})

        threading.Thread(target=produce, daemon=True).start()
        return await b, await b

    first, second = asyncio.run(consume())
    np.testing.assert_array_equal(_host(first["x"])[:, 0], [0.0, 1.0])
    np.testing.assert_array_equal(_host(second["x"])[:, 0], [2.0, 3.0])
    assert b.size() == 0


def test_await_cancellation_consumes_nothing(pkg):
    cls, _ = PKGS[pkg]
    b = cls(batch_size=1)

    async def awaiter():
        return await b

    async def main():
        with pytest.raises(asyncio.TimeoutError):
            await asyncio.wait_for(asyncio.ensure_future(awaiter()), 0.05)
        b.stack({"x": np.ones(2)})
        return b.get(timeout=2)

    np.testing.assert_array_equal(_host(asyncio.run(main())["x"]), [[1, 1]])


def test_close_wakes_an_awaiter(pkg):
    cls, _ = PKGS[pkg]
    b = cls(batch_size=1)

    async def main():
        task = asyncio.ensure_future(_awaiting(b))
        await asyncio.sleep(0.05)
        b.close()
        with pytest.raises(RuntimeError, match="closed"):
            await asyncio.wait_for(task, 5)

    asyncio.run(main())


async def _awaiting(b):
    return await b


def test_flush_of_nothing_and_of_a_partial_batch(pkg):
    cls, _ = PKGS[pkg]
    b = cls(batch_size=8)
    assert b.flush() is False
    b.stack({"x": np.zeros(2, np.float32)})
    assert b.empty() and b.flush() is True
    assert _host(b.get(timeout=1)["x"]).shape == (1, 2)
    assert b.flush() is False


def test_port_cats_torch_leaves_beside_numpy_leaves():
    """A learn unroll's tree mixes host frames and a core state the act
    step left as tensors: torch leaves cat with torch (staying tensors),
    numpy leaves with numpy, and the bytes equal an all-numpy batch's."""
    rng = np.random.default_rng(6)
    port = PortBatcher(batch_size=4, dim=1, dims={"core_state": 0})
    ref = RefBatcher(batch_size=4, dim=1, dims={"core_state": 0})
    for b in (3, 3, 2):
        u = _unroll(rng, 4, b)
        ref.cat(u)
        port.cat({**u, "core_state": tuple(
            torch.from_numpy(x) for x in u["core_state"])})
    r, p = _drain(ref), _drain(port)
    assert len(r) == len(p) == 2
    for x, y in zip(r, p):
        assert isinstance(y["obs"], np.ndarray)
        assert all(isinstance(c, torch.Tensor) for c in y["core_state"])
        _same(x, y)


def test_port_stages_completed_batches_to_the_device():
    rng = np.random.default_rng(7)
    host, staged = PortBatcher(batch_size=2), PortBatcher(batch_size=2,
                                                          device="cpu")
    for _ in range(2):
        it = _item(rng)
        host.stack(it)
        staged.stack(it)
    h, s = host.get(timeout=1), staged.get(timeout=1)
    assert isinstance(s["obs"], torch.Tensor) and s["obs"].device.type == "cpu"
    _same(h, s)
