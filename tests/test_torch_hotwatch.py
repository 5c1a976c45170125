"""The port's Hotwatch held to the reference's contracts
(``tests/test_hotwatch.py``) with ``device="cpu"``: a planted ``.item()``
is caught at its site with the stack, budgeted reads are counted, staged
copies are free, the ``numpy.asarray`` path is caught, a disabled window
patches nothing, the environment gate, patches restored, off-thread reads
free, uploads counted as h2d, a violation in user code wins, the learner's
steady state makes no read and the actor loop exactly its 2·N designed
reads. The reference's own file cannot run on this host (its jaxlib has no
``xla_extension``), so the expected counts are its tests' literals.
"""

import concurrent.futures

import numpy as np
import pytest
import torch

from moolib_tpu_torch.ops import _kernels
from moolib_tpu_torch.testing import Hotwatch, HotwatchViolation
from moolib_tpu_torch.testing.hotwatch import hotwatch_enabled
from moolib_tpu_torch.utils.staging import stage_host_async

CPU = "cpu"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The test processes run side by side: one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def step(s):
    return s + 1


def _window(**kw):
    kw.setdefault("device", CPU)
    return Hotwatch(**kw)


def test_planted_item_caught_with_site_stack():
    s = step(torch.zeros(8))
    with pytest.raises(HotwatchViolation) as ei:
        with _window(label="steady"):
            for _ in range(3):
                s = step(s)
                s.sum().item()  # the planted sync
    msg = str(ei.value)
    assert "steady" in msg
    assert "Materialization site" in msg
    assert "tests/test_torch_hotwatch.py" in msg


def test_budgeted_transfers_pass_and_are_counted():
    s = step(torch.zeros(8))
    with _window(d2h=2) as hw:
        for _ in range(4):
            s = step(s)
        float(s.sum())
    assert hw.d2h == 1
    assert hw.compile_delta == 0


def test_staged_copy_is_free():
    s = step(torch.zeros(8))
    with _window() as hw:
        for _ in range(3):
            s = step(s)
            stage_host_async(s)
    assert hw.d2h == 0
    assert hw.staged == 3


def test_np_asarray_path_is_caught():
    s = step(torch.zeros(8))
    with pytest.raises(HotwatchViolation):
        with _window():
            s = step(s)
            np.asarray(s)


def test_each_materializing_call_counts_once():
    """A method that reads through another (``np.asarray`` ->
    ``__array__`` -> ``numpy``) is one read, not three."""
    s = torch.arange(4.0)
    with _window(d2h=99) as hw:
        np.asarray(s)
        np.array(s)
        s.numpy()
        s.tolist()
        s.cpu()
        bool(s[1])
        int(s[1])
        s[1].item()
    assert hw.d2h == 8


def test_disabled_window_patches_nothing():
    before_item = torch.Tensor.item
    before_asarray = np.asarray
    s = step(torch.zeros(8))
    with _window(enabled=False) as hw:
        assert torch.Tensor.item is before_item
        assert np.asarray is before_asarray
        s = step(s)
        s.sum().item()
    assert hw.d2h == 0
    assert torch.Tensor.item is before_item


def test_env_gate(monkeypatch):
    monkeypatch.setenv("MOOLIB_TPU_HOTWATCH", "0")
    assert not hotwatch_enabled()
    assert not Hotwatch().enabled
    monkeypatch.setenv("MOOLIB_TPU_HOTWATCH", "1")
    assert hotwatch_enabled(default=False)
    monkeypatch.delenv("MOOLIB_TPU_HOTWATCH")
    assert hotwatch_enabled()


def test_patches_restored_after_window():
    before = {name: getattr(torch.Tensor, name)
              for name in ("item", "to", "__float__", "__array__")}
    before_np = (np.asarray, np.array, torch.as_tensor, torch.from_numpy)
    s = step(torch.zeros(8))
    with pytest.raises(HotwatchViolation):
        with _window():
            s.sum().item()
    for name, fn in before.items():
        assert getattr(torch.Tensor, name) is fn, name
        assert name not in vars(torch.Tensor) or name in ("__array__",), name
    assert (np.asarray, np.array, torch.as_tensor,
            torch.from_numpy) == before_np
    assert float(step(s)[0]) == pytest.approx(2.0)


def test_compile_flatness_counts_kernel_builds(tmp_path, monkeypatch):
    """The port's compiles are its kernel-library builds: one inside a
    window budgeted for none raises on exit; budgeted, it is counted."""
    src = tmp_path / "k.cu"
    src.write_text("// stand-in source\n")
    lib = _kernels.CudaLibrary("k", str(src))
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_kernels, "LIBRARIES", (*_kernels.LIBRARIES, lib))
    lib.library_path().write_bytes(b"")  # kept: _build reads it, no nvcc
    with pytest.raises(HotwatchViolation, match="built 1 time"):
        with _window(d2h=99):
            lib._build()
    with _window(d2h=99, max_compiles=1) as hw:
        lib._build()
    assert hw.compile_delta == 1


def test_off_thread_reads_are_free():
    s = step(torch.zeros(8))
    with _window() as hw:
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            # .result() re-raises here whatever the reader raised.
            pool.submit(lambda: (s.tolist(), np.asarray(s))).result()
        s = step(s)
    assert hw.d2h == 0


def test_h2d_disallow_catches_unstaged_upload():
    with pytest.raises(HotwatchViolation, match="[Dd]isallow"):
        with _window(d2h=99, h2d=0):
            step(torch.as_tensor(np.zeros((8,), dtype=np.float32)))


def test_h2d_counted_when_unbudgeted():
    with _window(d2h=99) as hw:
        for _ in range(3):
            step(torch.from_numpy(np.zeros((8,), dtype=np.float32)))
        step(torch.zeros(8))  # made on the device: no upload
    assert hw.h2d == 3


def test_violation_raised_inside_user_code_wins_over_exit_checks(
        tmp_path, monkeypatch):
    src = tmp_path / "k.cu"
    src.write_text("// stand-in source\n")
    lib = _kernels.CudaLibrary("k", str(src))
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_kernels, "LIBRARIES", (*_kernels.LIBRARIES, lib))
    lib.library_path().write_bytes(b"")
    with pytest.raises(ValueError, match="user"):
        with _window():
            lib._build()  # would be a compile violation
            raise ValueError("user error")


# -- e2e wiring: the real learner machinery under a window --------------------


def _a2c(t_dim=4, b_dim=4, f_dim=5, a_dim=3):
    from moolib_tpu_torch.models import A2CNet

    gen = torch.Generator().manual_seed(0)
    net = A2CNet(a_dim, f_dim, hidden_sizes=(16,), device=CPU, generator=gen)
    batch = {
        "obs": torch.randn((t_dim + 1, b_dim, f_dim), generator=gen),
        "done": torch.rand((t_dim + 1, b_dim), generator=gen) < 0.1,
        "rewards": torch.randn((t_dim + 1, b_dim), generator=gen),
        "actions": torch.randint(0, a_dim, (t_dim, b_dim), generator=gen),
        "behavior_logits": torch.zeros((t_dim, b_dim, a_dim)),
        "core_state": (),
    }
    return net, batch


def test_learner_e2e_steady_state_zero_transfers():
    """The port's IMPALA train step (metrics left on the device) runs a
    steady-state window with zero synchronous reads, zero uploads and no
    build."""
    from moolib_tpu_torch.learner import (ImpalaConfig,
                                          make_impala_train_step,
                                          make_train_state)

    net, batch = _a2c()
    state = make_train_state(net, torch.optim.SGD(net.parameters(), 1e-3))
    train_step = make_impala_train_step(config=ImpalaConfig())
    for _ in range(2):  # warmup: first-touch allocations
        state, metrics = train_step(state, batch)

    with _window(d2h=0, h2d=0, max_compiles=0, label="learner-e2e",
                 enabled=True) as hw:
        for _ in range(10):
            state, metrics = train_step(state, batch)
    assert hw.d2h == 0
    assert hw.h2d == 0
    assert hw.compile_delta == 0
    assert float(metrics["total_loss"]) == float(metrics["total_loss"])


def test_example_actor_loop_designed_syncs_exactly_budgeted():
    """The actor boundary: per step exactly two reads (the action feed
    and the behaviour logits riding the unroll buffer). A window
    budgeted for exactly 2*N passes and counts exactly 2*N."""
    from moolib_tpu_torch.learner import make_act_step

    b_dim, f_dim, a_dim = 4, 5, 3
    net, _ = _a2c(b_dim=b_dim, f_dim=f_dim, a_dim=a_dim)
    act = make_act_step(net)
    gen = torch.Generator().manual_seed(1)
    obs = torch.zeros((b_dim, f_dim))
    done = torch.zeros((b_dim,), dtype=torch.bool)
    a, logits, core = act(obs, done, (), gen)  # warm
    np.asarray(a), np.asarray(logits)

    n = 5
    with _window(d2h=2 * n, max_compiles=0, label="actor-loop",
                 enabled=True) as hw:
        for _ in range(n):
            a, logits, core = act(obs, done, core, gen)
            host_a = np.asarray(a)  # hotlint: sync -- designed: feeds the envs NOW
            host_l = np.asarray(logits)  # hotlint: sync -- designed: rides the unroll buf
    assert hw.d2h == 2 * n
    assert hw.compile_delta == 0
    assert host_a.shape == (b_dim,)
    assert host_l.shape == (b_dim, a_dim)


def test_entry_without_a_device_needs_the_card():
    """Like every entry point of the port: no device and no card raises
    on entry (nothing is patched)."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    before = torch.Tensor.item
    with pytest.raises(RuntimeError, match="CUDA"):
        with Hotwatch():
            pass
    assert torch.Tensor.item is before
