"""Port parity: Stats (moolib_tpu_torch.utils.stats), the
GlobalStatsAccumulator (moolib_tpu_torch.parallel.stats) and the
Checkpointer (moolib_tpu_torch.utils.checkpoint).

The same updates go into the port's and the reference's stats and give
the same results (exact). The cluster-wide stats over a group of port
peers, and over a group mixing port and reference peers, sum every
peer's env_steps exactly. A checkpoint of a dict of numpy arrays written
by either package loads in the other, bit for bit; a card-free tensor
tree round-trips; corruption raises the typed error and falls back to
the newest valid history copy; and a peer resumed from a checkpoint with
set_model_version wins the election and hands its state to a fresh peer.
Every wait has a deadline of its own.
"""

import math
import os
import pickle
import time

import numpy as np
import pytest
import torch

from moolib_tpu.parallel.stats import GlobalStatsAccumulator as RefGSA
from moolib_tpu.utils import checkpoint as ref_ckpt
from moolib_tpu.utils import stats as ref_stats
from moolib_tpu_torch.parallel import Accumulator, GlobalStatsAccumulator
from moolib_tpu_torch.utils import (
    CheckpointError,
    Checkpointer,
    StatMax,
    StatMean,
    Stats,
    StatSum,
    load_checkpoint,
    save_checkpoint,
)
from moolib_tpu_torch.utils import stats as port_stats
from test_torch_group import Cluster

STATS = {"port": port_stats, "ref": ref_stats}


def _drive(mod):
    """One sequence of updates on a module's stats; their results."""
    st = mod.Stats(loss=mod.StatMean(), steps=mod.StatSum(),
                   best=mod.StatMax(), cum=mod.StatMean(cumulative=True))
    for v in (4.0, 1.5, -2.0):
        st["loss"] += v
        st["steps"] += 128
        st["best"] += v
        st["cum"].add(v, count=2.0)
    out = [st.results()]
    st.reset()
    out.append(st.results())
    other = mod.StatMean()
    other.merge(st["cum"].diff(mod.StatMean()))
    out.append(other.result())
    out.append(mod.StatMax().result())
    return out


def test_stats_match_the_reference():
    port, ref = _drive(port_stats), _drive(ref_stats)
    assert math.isnan(port[1]["loss"]) and math.isnan(ref[1]["loss"])
    assert math.isnan(port[3]) and math.isnan(ref[3])
    for p, r in zip(port, ref):
        if isinstance(p, dict):
            assert {k: v for k, v in p.items() if not math.isnan(v)} == \
                {k: v for k, v in r.items() if not math.isnan(v)}
        elif not math.isnan(p):
            assert p == r
    assert port[0] == {"loss": 3.5 / 3, "steps": 384.0, "best": 4.0,
                       "cum": 3.5 / 6}


def _wait_idle(accs, timeout=10.0):
    deadline = time.monotonic() + timeout
    while any(a.busy for a in accs):
        assert time.monotonic() < deadline, "stats round never completed"
        time.sleep(0.02)


@pytest.mark.parametrize("pkgs", [("port",) * 3, ("port", "ref", "port")])
def test_global_stats_sum_env_steps_exactly(pkgs):
    cluster = Cluster()
    try:
        for i, pkg in enumerate(pkgs):
            cluster.spawn(f"peer-{i}", group="s", pkg=pkg)
        cluster.wait_members("s", len(pkgs))
        accs = []
        for i, ((_, g), pkg) in enumerate(zip(cluster.clients, pkgs)):
            mod = STATS[pkg]
            s = mod.Stats(env_steps=mod.StatSum(), loss=mod.StatMean(),
                          best=mod.StatMax())
            s["env_steps"] += 640 * (i + 1) + 3
            s["loss"].add(float(i), count=1.0)
            s["best"] += float(i)
            gsa = GlobalStatsAccumulator if pkg == "port" else RefGSA
            accs.append(gsa(g, s))
        for acc in accs:
            assert acc.enqueue_global_stats()
        _wait_idle(accs)
        want = sum(640 * (i + 1) + 3 for i in range(len(pkgs)))
        for acc in accs:
            r = acc.global_stats.results()
            assert r["env_steps"] == want
            assert r["loss"] == pytest.approx(1.0)
            assert r["best"] == 2.0
        # Snapshots are cumulative: a second round carries the new total.
        accs[0].stats["env_steps"] += 5
        for acc in accs:
            assert acc.enqueue_global_stats()
        _wait_idle(accs)
        for acc in accs:
            assert acc.global_stats.results()["env_steps"] == want + 5
    finally:
        cluster.close()


# -- checkpoints --------------------------------------------------------------

CKPT = {"port": (save_checkpoint, load_checkpoint),
        "ref": (ref_ckpt.save_checkpoint, ref_ckpt.load_checkpoint)}


def _numpy_state():
    rng = np.random.default_rng(4)
    return {"params": {"w": rng.standard_normal((3, 5)).astype(np.float32),
                       "b": rng.standard_normal(5)},
            "nu": {"w": rng.random((3, 5)).astype(np.float32)},
            "model_version": 12, "note": "hello"}


@pytest.mark.parametrize("writer,reader", [("port", "ref"), ("ref", "port"),
                                           ("port", "port")])
def test_checkpoint_loads_across_packages(tmp_path, writer, reader):
    path = str(tmp_path / "x.ckpt")
    state = _numpy_state()
    CKPT[writer][0](path, state)
    back = CKPT[reader][1](path)
    assert back["model_version"] == 12 and back["note"] == "hello"
    for part in ("params", "nu"):
        for k, v in state[part].items():
            assert isinstance(back[part][k], np.ndarray)
            assert back[part][k].dtype == v.dtype
            assert back[part][k].tobytes() == v.tobytes()


def test_checkpoint_of_tensors_roundtrips(tmp_path):
    path = str(tmp_path / "t.ckpt")
    w = torch.arange(6, dtype=torch.float32).reshape(2, 3).requires_grad_()
    save_checkpoint(path, {"w": w, "h": torch.ones(4, dtype=torch.bfloat16),
                           "step": 7})
    back = load_checkpoint(path)
    assert back["step"] == 7
    assert torch.equal(back["w"], w.detach()) and not back["w"].requires_grad
    assert back["h"].dtype == torch.bfloat16
    save_checkpoint(path, {"v": 2})  # atomic overwrite, no stray files
    assert load_checkpoint(path)["v"] == 2
    assert [f for f in os.listdir(tmp_path) if f.startswith(".tmp-")] == []


def test_checkpointer_interval_history_and_fallback(tmp_path):
    path = str(tmp_path / "m.ckpt")
    ck = Checkpointer(path, interval=100.0, history_interval=50.0)
    t0 = time.time()
    assert ck.maybe_save(lambda: {"v": 1}, now=t0 + 101)
    assert not ck.maybe_save(lambda: {"v": 2}, now=t0 + 150)
    assert ck.maybe_save(lambda: {"v": 3}, now=t0 + 202)
    assert ck.load()["v"] == 3
    assert ck.history_paths(), "a versioned history copy exists"
    # A corrupt primary falls back to the newest valid history copy.
    raw = open(path, "rb").read()
    open(path, "wb").write(raw[: len(raw) // 2])
    with pytest.raises(CheckpointError):
        load_checkpoint(path)
    assert ck.load()["v"] == 3
    p = tmp_path / "junk.pkl"
    p.write_bytes(pickle.dumps({"not": "a checkpoint"}))
    with pytest.raises(CheckpointError):
        load_checkpoint(str(p))
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path / "absent.ckpt"))
    assert Checkpointer(str(tmp_path / "none.ckpt")).load() is None


def test_resumed_peer_wins_the_election_and_hands_over_its_state(tmp_path):
    """experiment.py's resume: the checkpoint holder calls
    set_model_version before joining, wins the election, and a fresh peer
    receives its state."""
    path = str(tmp_path / "ckpt.ckpt")
    Checkpointer(path).save({"state": {"w": np.arange(4.0)},
                             "model_version": 9})
    cluster = Cluster()
    try:
        saved = Checkpointer(path).load()
        held = dict(saved["state"])
        rpc, g = cluster.spawn("resumed")
        resumed = Accumulator(rpc, group=g, virtual_batch_size=2,
                              get_state=lambda: held)
        resumed.set_model_version(saved["model_version"])
        got = {}
        rpc2, g2 = cluster.spawn("fresh")
        fresh = Accumulator(rpc2, group=g2, virtual_batch_size=2,
                            get_state=lambda: {"w": np.zeros(4)},
                            set_state=got.update)
        accs = [fresh, resumed]
        deadline = time.monotonic() + 20
        while not (all(a.connected() for a in accs)
                   and fresh.get_gradient_stats()["synced"]):
            assert time.monotonic() < deadline
            for a in accs:
                a.update()
            time.sleep(0.005)
        assert {a.get_leader() for a in accs} == {"resumed"}
        assert fresh.model_version == 9
        np.testing.assert_array_equal(got["w"], np.arange(4.0))
    finally:
        cluster.close()


def test_stat_classes_are_exported():
    import moolib_tpu_torch as m

    assert (m.Stats, m.StatSum, m.StatMean, m.StatMax, m.Checkpointer) == (
        Stats, StatSum, StatMean, StatMax, Checkpointer)
    assert m.GlobalStatsAccumulator is GlobalStatsAccumulator
