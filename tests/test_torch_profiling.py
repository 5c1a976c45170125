"""The port's profiler capture (``moolib_tpu_torch.utils.profiling``)
against the reference's ``moolib_tpu.utils.profiling``: the same public
names, and a ``profile_trace`` window that writes a loadable Chrome trace
and marks itself on the telemetry timeline (the twin of
``tests/test_tools.py::test_profile_trace_capture``)."""

import json
import os

import pytest
import torch

import moolib_tpu.utils.profiling as ref_profiling
import moolib_tpu_torch.telemetry as telemetry
import moolib_tpu_torch.utils as tutils
from moolib_tpu_torch.utils import profiling


def test_profiling_exports_every_name_of_the_reference():
    assert set(ref_profiling.__all__) <= set(profiling.__all__)
    for name in ref_profiling.__all__:
        assert callable(getattr(profiling, name))
        assert getattr(tutils, name) is getattr(profiling, name)


def test_profile_trace_capture(tmp_path, monkeypatch):
    """A window writes trace.json (a Chrome trace holding the block's
    operators) into the logdir and leaves one ``profiler`` span, with the
    logdir, on the telemetry buffer."""
    tel = telemetry.Telemetry("global")
    monkeypatch.setattr(telemetry, "_global", tel)
    d = str(tmp_path / "trace")
    with profiling.profile_trace(d):
        float(torch.ones((8, 8)).sum())
    with open(os.path.join(d, profiling.TRACE_FILE)) as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert any("aten::ones" in str(n) for n in names), sorted(map(str, names))
    spans = [s for s in tel.traces.spans() if s.cat == "profiler"]
    assert [s.name for s in spans] == ["torch_profiler_capture"]
    assert spans[0].args["logdir"] == d
    assert spans[0].dur >= 0


def test_profile_trace_records_the_window_when_the_block_raises(
        tmp_path, monkeypatch):
    """The block's exception propagates; the trace is still written and
    the window still marked, as the reference's ``finally`` does."""
    tel = telemetry.Telemetry("global")
    monkeypatch.setattr(telemetry, "_global", tel)
    d = str(tmp_path / "trace")
    with pytest.raises(KeyError, match="inside"):
        with profiling.profile_trace(d):
            raise KeyError("inside")
    assert os.path.exists(os.path.join(d, profiling.TRACE_FILE))
    assert [s.cat for s in tel.traces.spans()] == ["profiler"]
