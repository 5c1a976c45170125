"""The torch counterparts of the reference's four JAX rule families
(capture hygiene, hotlint, numlint, mesh/collective consistency): a
flagged and a clean planted source for every rule, each "not ported"
reason through ``moolint --explain``, hotlint held against the port's
``Hotwatch`` on the CPU, and ``recompile_guard`` on kernel-library build
counts (stubbed on the CPU: no card, no nvcc)."""

import json
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from moolib_tpu_torch.analysis import (
    RecompileBudgetExceeded,
    RecompileGuard,
    compile_count,
    guarded_jit,
    kernel_builds,
    lint_paths,
    lint_source,
    not_ported_rules,
    recompile_budget,
)

REPO_ROOT = Path(__file__).resolve().parent.parent


def _lint(src, only, relpath="moolib_tpu_torch/scratch.py"):
    return lint_source(textwrap.dedent(src), relpath, only=only)


def _rules(findings):
    return [f.rule for f in findings]


def _lines(findings):
    return [f.line for f in findings]


# -- capture hygiene (rules_jax) ----------------------------------------------


def test_host_sync_in_jit_flags_reads_in_compiled_functions():
    src = """
    import numpy as np
    import torch

    @torch.compile
    def step(x):
        y = x * 2
        n = float(y.sum())
        v = y.item()
        h = y.cpu()
        a = np.asarray(y)
        torch.cuda.synchronize()
        return y

    def fwd(x):
        return x.tolist()

    fast = torch.compile(fwd, mode="max-autotune")

    @torch.compile(fullgraph=True)
    def other(x):
        return bool(x.any())
    """
    findings = _lint(src, ["host-sync-in-jit"])
    assert _lines(findings) == [8, 9, 10, 11, 12, 16, 22]
    assert "captured region" in findings[0].message


def test_host_sync_in_jit_flags_cuda_graph_capture_bodies():
    src = """
    import torch

    def capture(g, static_x, model):
        with torch.cuda.graph(g):
            out = model(static_x)
            print(out.item())
        return out.item()      # after the capture: fine
    """
    assert _lines(_lint(src, ["host-sync-in-jit"])) == [7]


def test_host_sync_in_jit_clean_outside_regions_and_on_re_compile():
    src = """
    import re
    import torch

    pattern = re.compile("x")

    def log(x):
        return float(x.sum()), x.item(), x.cpu()

    @pattern.fullmatch
    def not_a_region(x):
        return x.item()

    @torch.compile
    def step(x):
        return x * float(2)
    """
    assert _lint(src, ["host-sync-in-jit"]) == []


def test_python_random_in_jit_flagged_and_torch_sampling_clean():
    src = """
    import random
    import numpy as np
    import torch

    @torch.compile
    def step(x):
        noise = random.random()
        jitter = np.random.normal()
        return x + noise + jitter

    @torch.compile
    def good(x, gen):
        return x + torch.rand(x.shape, generator=gen)

    def eager(x):
        return x + random.random()
    """
    findings = _lint(src, ["python-random-in-jit"])
    assert _lines(findings) == [8, 9]
    assert "capture time" in findings[0].message


# -- hotlint (rules_hot) --------------------------------------------------------


_HOT = ["host-transfer-in-steploop", "sync-in-dispatch-shadow",
        "device-alloc-in-steploop", "python-loop-over-device-array",
        "hot-bare-suppression"]


def test_host_transfer_in_steploop_flags_reads_of_step_results():
    src = """
    import numpy as np
    from moolib_tpu_torch.learner import make_impala_train_step

    def train(state, batches, log_every):
        step = make_impala_train_step()
        for i, batch in enumerate(batches):
            state, m = step(state, batch)
            loss = m["total_loss"].item()
            n = float(m["grad_norm"])
            h = np.asarray(m["entropy"])
            c = m["pg_loss"].cpu()
            print(f"{m['total_loss']}")
            if i % log_every == 0:
                print(float(m["total_loss"]))   # log boundary: exempt
        return state
    """
    findings = _lint(src, _HOT)
    assert _rules(findings) == ["host-transfer-in-steploop"] * 5
    assert _lines(findings) == [9, 10, 11, 12, 13]


def test_host_transfer_follows_modules_aliases_and_factories():
    src = """
    import functools
    import torch
    from torch import nn
    from moolib_tpu_torch import learner as L

    class Net(nn.Module):
        def forward(self, x):
            return x

    class Deeper(Net):
        pass

    def build():
        return L.make_act_step(Net())

    def run(obs, gen):
        net = Deeper()
        lin = nn.Linear(3, 3)
        act = build()
        act2 = functools.partial(act, gen=gen)
        for o in obs:
            y = net(o)
            z = lin(o)
            a, logits, core = act2(o)
            print(y.tolist(), int(z[0]), bool(a.any()))
    """
    findings = _lint(src, ["host-transfer-in-steploop"])
    assert len(findings) == 3 and set(_lines(findings)) == {26}


def test_host_transfer_clean_when_staged_suppressed_or_cold():
    src = """
    from moolib_tpu_torch.learner import make_impala_train_step
    from moolib_tpu_torch.utils.staging import host_result, stage_host_async

    def train(state, batches):
        step = make_impala_train_step()
        pending = None
        for batch in batches:
            state, m = step(state, batch)
            if pending is not None:
                loss = host_result(pending)
                print(float(loss))
            pending = stage_host_async(m["total_loss"])
            keep = m["grad_norm"].item()  # hotlint: sync -- the checkpoint boundary
        return state

    def once(state, batch):
        step = make_impala_train_step()
        state, m = step(state, batch)
        return float(m["total_loss"])   # not in a loop
    """
    assert _lint(src, _HOT) == []


def test_hot_bare_suppression_flagged_and_suppresses_nothing():
    src = """
    from moolib_tpu_torch.learner import make_grad_step

    def go(model, batches):
        grad = make_grad_step()
        for b in batches:
            g, m = grad(model, b)
            x = m["total_loss"].item()  # hotlint: sync
    """
    assert sorted(_rules(_lint(src, _HOT))) == [
        "host-transfer-in-steploop", "hot-bare-suppression"]


def test_sync_in_dispatch_shadow_flagged_and_clean():
    src = """
    import torch
    import torch.distributed as dist
    from moolib_tpu_torch.parallel import collectives

    def overlap(x, y, model, mesh):
        xd = x.to("cuda", non_blocking=True)
        torch.cuda.synchronize()                  # flags: xd used below
        work = dist.all_reduce(y, async_op=True)
        ev = torch.cuda.Event()
        ev.synchronize()                          # flags: work used below
        work.wait()
        s = collectives.psum(y, mesh, "dp")
        n = s.item()                              # flags: s used below
        return model(xd), s * n

    def ok(x, model):
        xd = x.to("cuda", non_blocking=True)
        out = model(xd)
        torch.cuda.synchronize()                  # after the last use
        return out
    """
    findings = _lint(src, ["sync-in-dispatch-shadow"])
    assert _lines(findings) == [8, 11, 14]
    assert findings[0].message.startswith("torch.cuda.synchronize()")


def test_sync_in_dispatch_shadow_exempts_bench_paths():
    src = """
    import torch

    def time_it(x, model):
        xd = x.to("cuda", non_blocking=True)
        torch.cuda.synchronize()
        return model(xd)
    """
    assert _lint(src, ["sync-in-dispatch-shadow"],
                 relpath="moolib_tpu_torch/tools/attn_bench.py") == []
    assert _lint(src, ["sync-in-dispatch-shadow"])


def test_device_alloc_in_steploop_flagged_and_clean():
    src = """
    import torch
    from moolib_tpu_torch.learner import make_act_step

    def act_loop(model, frames, n):
        act = make_act_step(model)
        for t, obs in enumerate(frames):
            done = torch.zeros(n, dtype=torch.bool, device="cuda")   # flags
            step_t = torch.full((n,), t, device="cuda")     # varies: fine
            host = torch.zeros(n)                           # host: fine
            a, logits, core = act(obs, done, (), None)
    """
    findings = _lint(src, ["device-alloc-in-steploop"])
    assert _lines(findings) == [8]
    assert "hoist" in findings[0].message


def test_python_loop_over_device_array_flagged_and_mapping_exempt():
    src = """
    from moolib_tpu_torch.learner import make_act_step, make_grad_step

    def go(model, obs, done, batch):
        act = make_act_step(model)
        grad = make_grad_step()
        a, logits, core = act(obs, done, (), None)
        for x in a:                    # flags: element by element
            print(x)
        for i in range(len(logits)):
            print(logits[i])           # flags: per-element indexing
        grads, metrics = grad(model, batch)
        for name in metrics:           # a dict iterated by key: fine
            print(name, metrics[name])
    """
    findings = _lint(src, ["python-loop-over-device-array"])
    assert _lines(findings) == [8, 11]


# -- numlint (rules_num) --------------------------------------------------------


def test_prng_key_reuse_flags_reseeded_streams():
    src = """
    import torch

    def streams(seed, n):
        g_env = torch.Generator().manual_seed(seed)
        g_net = torch.Generator().manual_seed(seed)      # flags: same stream
        a = torch.Generator().manual_seed(7)
        b = torch.Generator().manual_seed(7)             # flags
        for _ in range(n):
            torch.manual_seed(seed)                      # flags: invariant
        return g_env, g_net, a, b
    """
    findings = _lint(src, ["prng-key-reuse"])
    assert _lines(findings) == [6, 8, 10]
    assert "first at line 5" in findings[0].message


def test_prng_key_reuse_clean_forms():
    src = """
    import torch

    def pick(seed, cuda):
        if cuda:
            g = torch.Generator("cuda").manual_seed(seed)
        else:
            g = torch.Generator().manual_seed(seed)       # sibling arm
        return g

    def streams(seed, n):
        g_env = torch.Generator().manual_seed(seed)
        g_net = torch.Generator().manual_seed(seed + 1)   # computed
        for i in range(n):
            torch.manual_seed(seed + i)                   # varies
        for s in range(n):
            torch.manual_seed(s)                          # the loop var
        seed = seed * 2
        again = torch.Generator().manual_seed(seed)       # rebound name
        twin = torch.Generator().manual_seed(0)
        twin2 = torch.Generator().manual_seed(0)  # numlint: prng-key-reuse -- twin models must draw alike
        return g_env, g_net, again, twin, twin2
    """
    assert _lint(src, ["prng-key-reuse", "num-bare-suppression"]) == []


def test_unseeded_randomness_flags_global_generators_and_clock_seeds():
    src = """
    import time
    import numpy as np
    import torch

    def noise(shape, w):
        a = torch.randn(shape)                          # flags
        b = torch.randint(0, 4, shape)                  # flags
        w.normal_()                                     # flags
        c = np.random.normal(size=shape)                # flags
        torch.manual_seed(int(time.time()))             # flags
        g = torch.Generator().manual_seed(time.time_ns())   # flags
        rng = np.random.default_rng(int(time.time()))   # flags
        return a, b, c, g, rng
    """
    findings = _lint(src, ["unseeded-randomness"])
    assert _lines(findings) == [7, 8, 9, 10, 11, 12, 13]
    assert "generator=" in findings[0].message


def test_unseeded_randomness_clean_and_scoped():
    src = """
    import numpy as np
    import torch

    def noise(shape, w, seed):
        gen = torch.Generator().manual_seed(seed)
        a = torch.randn(shape, generator=gen)
        w.normal_(generator=gen)
        rng = np.random.default_rng(seed)
        return a, rng.normal(size=shape)
    """
    assert _lint(src, ["unseeded-randomness"]) == []
    bad = "import torch\nx = torch.rand(3)\n"
    for rel in ("moolib_tpu_torch/testing/chaos.py",
                "moolib_tpu_torch/tools/perf.py", "tests/test_x.py",
                "bench_torch.py", "moolib_tpu/learner.py"):
        assert lint_source(bad, rel, only=["unseeded-randomness"]) == [], rel
    assert lint_source(bad, "moolib_tpu_torch/learner.py",
                       only=["unseeded-randomness"])


def test_lowprec_accumulate_flagged_and_upcast_clean():
    src = """
    import torch

    def head(h, w, x):
        acts = h.to(torch.bfloat16)
        half = torch.zeros(4, dtype=torch.float16)
        loss = acts.mean()                         # flags
        s = torch.sum(half)                        # flags
        y = torch.matmul(acts, w)                  # flags
        z = acts @ w                               # flags
        c = acts.view(-1).cumsum(0)                # flags (view keeps bf16)
        e = torch.einsum("ij,jk->ik", acts, w)     # flags
        ok1 = acts.mean(dtype=torch.float32)
        ok2 = torch.matmul(acts.float(), w.float())
        up = acts.float()
        ok3 = up.sum()
        ok4 = x.to(torch.float32).sum()
        return loss, s, y, z, c, e, ok1, ok2, ok3, ok4
    """
    findings = _lint(src, ["lowprec-accumulate"])
    assert _lines(findings) == [7, 8, 9, 10, 11, 12]


def test_implicit_dtype_promotion_inside_steps():
    src = """
    import torch
    from torch import nn

    class Net(nn.Module):
        def forward(self, x, bias):
            x16 = x.to(torch.bfloat16)
            f32 = bias.float()
            a = x16 * 0.1                      # flags: literal
            b = x16 + f32                      # flags: promotes to f32
            c = torch.zeros(3, dtype=torch.float64)   # flags: fp64
            ok = x16 * torch.tensor(0.1, dtype=torch.bfloat16)
            return a, b, c, ok

    def make_train_step():
        def step(x):
            x16 = x.half()
            return 2.0 * x16                   # flags: literal
        return step

    def not_a_step(x):
        x16 = x.to(torch.bfloat16)
        return x16 * 0.1                       # outside any step: silent
    """
    findings = _lint(src, ["implicit-dtype-promotion"])
    assert _lines(findings) == [9, 10, 11, 18]
    assert "promotion makes the result f32" in findings[1].message


def test_nondet_iteration_to_tensor_flagged_and_sorted_clean():
    src = """
    import torch

    def pack(peers, grads):
        names = {p.name for p in peers}
        flat = torch.stack([grads[n] for n in names])        # flags
        vals = torch.tensor(list(names))                     # flags
        by = {n: grads[n] for n in names}
        cat = torch.cat(list(by.values()))                   # flags
        ok = torch.stack([grads[n] for n in sorted(names)])
        plain = {"a": 1, "b": 2}
        ok2 = torch.tensor(list(plain.values()))
        return flat, vals, cat, ok, ok2
    """
    findings = _lint(src, ["nondet-iteration-to-tensor"])
    assert _lines(findings) == [6, 7, 9]


def test_num_bare_and_unknown_markers_flagged():
    src = """
    import torch

    def f(seed):
        a = torch.Generator().manual_seed(seed)
        b = torch.Generator().manual_seed(seed)  # numlint: prng-key-reuse
        c = 1  # numlint: no-such-rule -- typo
        return a, b, c
    """
    findings = _lint(src, ["prng-key-reuse", "num-bare-suppression"])
    assert sorted(_rules(findings)) == ["num-bare-suppression"] * 2 + [
        "prng-key-reuse"]


# -- mesh/collective consistency (rules_sharding) -------------------------------


def test_collective_axis_unbound_flagged_and_bound_clean():
    src = """
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
    from moolib_tpu_torch.parallel import collectives

    AXES = ("dp", "tp")

    def go(x, ranks):
        mesh = DeviceMesh("cuda", ranks, mesh_dim_names=AXES)
        a = collectives.psum(x, mesh, "dp")                  # bound
        b = collectives.pmean(x, mesh, axis_name="sp")       # flags
        c = collectives.ppermute(x, mesh, [(0, 1)], "ep")    # flags
        n = collectives.axis_size(mesh, "tp")                # bound
        i = collectives.axis_index(mesh, axis_name="pp")     # flags
        flat = init_device_mesh("cuda", (4,), mesh_dim_names=("dp",))
        d = collectives.all_to_all(x, flat, "tp")            # flags
        e = collectives.psum(x, mesh["dp"], "tp")            # flags: a slice
        f = collectives.psum(x, unknown_mesh, "zz")          # unresolvable
        g = collectives.psum(x, mesh, name)                  # variable axis
        return a, b, c, n, i, d, e, f, g
    """
    findings = _lint(src, ["collective-axis-unbound"])
    assert _lines(findings) == [10, 11, 13, 15, 16]
    assert findings[0].message == (
        "collective names axis 'sp' but its mesh has only ['dp', 'tp']")


def test_collective_axis_resolves_the_ports_make_mesh(tmp_path):
    """Two hops through the port's real parallel/mesh.py: make_mesh ->
    DeviceMesh(..., mesh_dim_names=AXES) -> the module's AXES tuple; and
    a helper that forwards its axis into a collective is checked too."""
    planted = tmp_path / "planted.py"
    planted.write_text(textwrap.dedent("""
        from moolib_tpu_torch.parallel import collectives
        from moolib_tpu_torch.parallel.mesh import make_mesh, psum_gradients

        def build():
            return make_mesh(tp=2)

        def go(x, grads):
            mesh = make_mesh(tp=2)
            ok = collectives.psum(x, mesh, "ep")
            bad = collectives.psum(x, mesh, "model")           # flags
            far = collectives.axis_index(build(), "data")      # flags
            g = psum_gradients(grads, mesh, axis_name="batch")  # flags
            return ok, bad, far, g
    """))
    mesh_py = REPO_ROOT / "moolib_tpu_torch" / "parallel" / "mesh.py"
    coll_py = REPO_ROOT / "moolib_tpu_torch" / "parallel" / "collectives.py"
    findings = [f for f in lint_paths([mesh_py, coll_py, planted],
                                      root=REPO_ROOT,
                                      only=["collective-axis-unbound"])
                if f.path.endswith("planted.py")]
    assert _lines(findings) == [11, 12, 13]
    assert findings[2].message.startswith("helper call passes "
                                          "axis_name='batch'")
    assert "['dp', 'ep', 'pp', 'sp', 'tp']" in findings[0].message


def test_pspec_axis_unbound_flagged_and_clean():
    src = """
    from torch.distributed.device_mesh import init_device_mesh
    from moolib_tpu_torch.parallel import mesh as pmesh

    def shard(batch, x):
        mesh = init_device_mesh("cuda", (2, 2), mesh_dim_names=("dp", "tp"))
        ok = pmesh.placements(mesh, (None, "dp"))
        bad = pmesh.placements(mesh, (None, "sp"))            # flags
        spec = ("tp", "ep")
        bad2 = pmesh.placements(mesh, spec)                   # flags (ep)
        leaf = pmesh.batch_leaf_spec(x, 1, axis_name="pp")    # flags
        specs = pmesh.batch_specs(batch, axis_name="dp")      # bound
        return ok, bad, bad2, leaf, specs

    def no_mesh(x):
        return batch_leaf_spec(x, axis_name="pp")            # no mesh: silent
    """
    findings = _lint(src, ["pspec-axis-unbound"])
    assert _lines(findings) == [8, 9, 11]   # a named spec: at its literal
    assert findings[1].message == (
        "spec names axis 'ep' but the mesh has only ['dp', 'tp']")


# -- not ported -----------------------------------------------------------------


@pytest.mark.parametrize("name", ["jit-missing-donation",
                                  "donated-buffer-reuse",
                                  "pallas-blockspec-static",
                                  "jit-missing-static"])
def test_explain_prints_why_a_rule_is_not_ported(name):
    proc = subprocess.run(
        [sys.executable, "-m", "moolib_tpu_torch.tools.moolint", "--explain",
         name, "--json"], capture_output=True, text=True,
        cwd=str(REPO_ROOT), timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout) == [
        {"name": name, "not_ported": not_ported_rules()[name]}]
    with pytest.raises(Exception):
        lint_source("x = 1\n", only=[name])


# -- hotlint against Hotwatch ---------------------------------------------------


_HOT_LOOP = """
import torch
from torch import nn


class Net(nn.Module):
    def __init__(self):
        super().__init__()
        self.lin = nn.Linear(4, 2)

    def forward(self, x):
        return self.lin(x)


NET = Net()


def loop(frames):
    out = []
    for x in frames:
        y = NET(x)
        out.append({read})
    return out
"""


@pytest.mark.parametrize("read, flagged, reads", [
    ("float(y.sum())", True, 1),      # a blocking read per step
    ("y.sum()", False, 0),            # stays a tensor
])
def test_hotlint_agrees_with_hotwatch_on_the_cpu(read, flagged, reads):
    """The planted loop the static rule flags also counts a device->host
    read per step under Hotwatch(device="cpu"); its clean twin counts
    none."""
    from moolib_tpu_torch.testing.hotwatch import Hotwatch

    src = _HOT_LOOP.format(read=read)
    findings = lint_source(src, "moolib_tpu_torch/planted.py",
                           only=["host-transfer-in-steploop"])
    assert bool(findings) == flagged
    scope = {}
    exec(compile(src, "planted.py", "exec"), scope)
    frames = [torch.from_numpy(np.full((3, 4), i, np.float32))
              for i in range(5)]
    with torch.no_grad():  # an acting loop: no graph to keep
        scope["loop"](frames[:1])  # warm, outside the window
        with Hotwatch(device="cpu", d2h=len(frames), enabled=True) as hw:
            scope["loop"](frames)
    assert hw.d2h == reads * len(frames)


# -- recompile_guard ------------------------------------------------------------


class _Lib:
    """A stand-in kernel library: ``builds`` as CudaLibrary keeps it."""

    def __init__(self, name):
        self.name = name
        self.builds = 0

    def load(self):
        if not getattr(self, "_lib", None):
            self.builds += 1
            self._lib = object()
        return self._lib


@pytest.fixture
def stub_libraries(monkeypatch):
    from moolib_tpu_torch.ops import _kernels

    libs = (_Lib("flash_fwd"), _Lib("flash_bwd"))
    monkeypatch.setattr(_kernels, "LIBRARIES", libs)
    return libs


def test_recompile_budget_passes_and_counts(stub_libraries):
    fwd, bwd = stub_libraries
    assert kernel_builds() == 0

    def build_all():
        for lib in stub_libraries:
            lib.load()

    guarded = guarded_jit(build_all)
    with RecompileGuard(guarded, max_compiles=2) as guard:
        guarded()
    assert guard.compiles == 2 == kernel_builds()

    def step(x):
        fwd.load()        # already built: no new build
        return x * 2

    step = guarded_jit(step)
    with recompile_budget(step, max_compiles=0) as guard:
        for i in range(3):
            assert step(i) == 2 * i
    assert guard.compiles == 0 and step.compiles == 0
    assert step.__name__ == "step"
    # A kernel library counts itself.
    assert compile_count(fwd) == compile_count(bwd) == 1


def test_recompile_budget_overrun_raises(stub_libraries):
    late = stub_libraries[1]

    @guarded_jit
    def step(x):
        late.load()       # a first-use build on the steady path
        return x

    with pytest.raises(RecompileBudgetExceeded, match="budgeted for 0"):
        with recompile_budget(step, max_compiles=0):
            step(1)
    assert step.compiles == 1
    # An exception raised inside the block wins over the budget check.
    with pytest.raises(KeyError):
        with recompile_budget(step, max_compiles=0):
            late._lib = None
            step(1)
            raise KeyError("inner")


def test_recompile_budget_rejects_uncountable_callables():
    with pytest.raises(TypeError, match="guarded_jit"):
        recompile_budget(lambda x: x)
    with pytest.raises(TypeError):
        RecompileGuard(object())
    with pytest.raises(TypeError):
        guarded_jit(lambda x: x, static_argnames=("n",))
    assert compile_count(lambda x: x) is None


def test_hotwatch_reads_the_same_build_counter(stub_libraries):
    from moolib_tpu_torch.testing.hotwatch import Hotwatch, HotwatchViolation

    with Hotwatch(device="cpu", max_compiles=1, enabled=True) as hw:
        stub_libraries[0].load()
    assert hw.compile_delta == 1
    with pytest.raises(HotwatchViolation):
        with Hotwatch(device="cpu", max_compiles=0, enabled=True):
            stub_libraries[1].load()
