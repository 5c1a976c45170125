"""Port parity: the serving tier's chaos scenarios (``ServingFleet``,
``replica_kill``, ``router_partition``) and the load generator
(moolib_tpu_torch.tools.serving_load), on the CPU.

The port's Replicas serve the reference's toy model (``x * scale``)
behind the port's Router, with ``device="cpu"``; each scenario runs with
its reference test's seed (tests/test_chaos.py) and must return the
summary that test asserts, the exact one on two runs with one log.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from moolib_tpu_torch.testing import scenarios
from test_torch_scenarios_wire import replayed

REPO_ROOT = Path(__file__).resolve().parent.parent


def test_replica_kill_scenario_replays_its_pinned_log(monkeypatch):
    (s1, log1), (s2, log2) = replayed(monkeypatch, "replica_kill", 101,
                                      device="cpu")
    assert s1 == s2 == {"conn_kill": 1}
    assert log1 == log2 and [e[1] for e in log1] == ["conn_kill"]


def test_router_partition_scenario():
    summary = scenarios.scenario_router_partition(seed=202, device="cpu")
    assert summary.get("partition") == 2, summary  # start + heal
    assert summary.get("partitioned", 0) >= 1, summary


def test_serving_fleet_serves_the_toy_model_on_the_asked_device():
    fleet = scenarios.ServingFleet(2, seed=3, device="cpu")
    try:
        fleet.wait_routable(2)
        assert {str(r.device) for r in fleet.replicas} == {"cpu"}
        out = fleet.router.infer(np.arange(4, dtype=np.float32),
                                 budget_s=8.0)
        np.testing.assert_array_equal(np.asarray(out),
                                      2.0 * np.arange(4, dtype=np.float32))
        assert fleet.router_rpc in fleet.all_rpcs()
    finally:
        fleet.close()


def test_serving_load_cpu_smoke_accounts_for_every_request():
    proc = subprocess.run(
        [sys.executable, "-m", "moolib_tpu_torch.tools.serving_load",
         "--replicas", "3", "--requests", "60", "--kill-after", "20",
         "--device", "cpu"],
        cwd=str(REPO_ROOT), capture_output=True, text=True, timeout=180,
        env={**os.environ, "PYTHONPATH": str(REPO_ROOT)},
    )
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["killed_one"] and report["device"] == "cpu"
    assert report["ok"] + sum(report["errors"].values()) == 60, report
    assert proc.returncode == (0 if not report["errors"] else 1)
    assert report["ok"] >= 48, report  # the kill costs few requests
    # The warm-up request rides the router too.
    assert report["router"]["requests"] == 61
    assert report["router"]["ok"] == report["ok"] + 1


def test_toy_model_scales_on_the_requests_device():
    """A scale published over the wire arrives as a 0-d numpy array;
    ``tensor * ndarray`` is numpy's multiply, which reads the tensor back
    to the host (on a card tensor: a TypeError). The scenarios' model
    multiplies on the request's device; a meta tensor stands in for a
    card tensor here (it has no host copy either)."""
    x = torch.ones(4, device="meta")
    scale = np.array(3.0, np.float32)
    with pytest.raises((TypeError, NotImplementedError)):
        x * scale  # noqa: B018
    out = scenarios._scaled({"scale": scale}, x)
    assert out.device == x.device and out.dtype == torch.float32
    host = scenarios._fleet_model({"scale": scale}, torch.ones(4))
    assert torch.equal(host, torch.full((4,), 3.0))
