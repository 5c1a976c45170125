"""Read the two ends each limit of ``limits/<cell>.json`` is set
between, on the card, at the cell's own size:

- the program's numbers over many seeds (its set-up and first three
  steps, as a run makes them; no measured window is needed);
- the control's: the reference put in the program's place, computed one
  step below the configuration's precision (its ``control``: ``fp8``
  below bf16, ``tf32`` below f32);
- a planted fault: the reference in the program's place with half of
  each batch left out (the mean taken over the rest);
- a step that leaves the state unchanged, read from each program seed's
  reference (``check.unchanged``): 1 on ``grad_gap`` and ``change_gap``
  by their definition, and what it reads on the others.

    python3 cellbench/calibrate.py --workload <name> --seeds 1,2,3 \
        --control-seeds 4,5,6 --out cal.json
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def _seeds(text: str):
    return [int(s) for s in text.split(",") if s]


def program_numbers(cell, seed: int, device, detail=None,
                    unchanged=None) -> dict:
    """The program's numbers; ``unchanged``, a dict, receives those of a
    state left unchanged against the same reference."""
    from cellbench.loops import learn

    weights, batches, _ = learn.prepare(cell, seed, device)
    learner = learn.Learner(cell, weights, device)
    program = learn.check_steps(learner, weights, batches)
    del learner
    learn.free(device)
    return learn.reference_numbers(cell.config, weights, batches, program,
                                   detail, unchanged)


def stand_in_numbers(cell, seed: int, device, precision: str = "f32",
                     fault: str = "", detail=None) -> dict:
    """The reference in the program's place, in ``precision`` or with
    ``fault`` planted, against the reference."""
    from cellbench import check
    from cellbench.loops import learn
    from cellbench.reference.step import run_steps

    weights, batches, _ = learn.prepare(cell, seed, device)
    first = batches[:learn.CHECK_STEPS]
    stand_in = run_steps(cell.config, weights, first, precision, fault)
    ref = run_steps(cell.config, weights, first)
    if detail is not None:
        detail.update(check.detail(stand_in, ref))
    return check.numbers(stand_in, ref, cell.config)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    import torch

    from cellbench.lookup import Cell

    cell = Cell(args.workload)
    device = torch.device(args.device)
    out = {"workload": args.workload, "control": cell.config["control"],
           "device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu"),
           "program": {}, "control_run": {}, "half_batch": {},
           "unchanged": {}, "detail": {}}
    plan = ([("program", s) for s in _seeds(args.seeds)]
            + [("control_run", s) for s in _seeds(args.control_seeds)]
            + [("half_batch", s) for s in _seeds(args.fault_seeds)])
    for kind, seed in plan:
        t = time.perf_counter()
        detail = {}
        if kind == "program":
            still = {}
            found = program_numbers(cell, seed, device, detail, still)
            out["unchanged"][str(seed)] = still
        elif kind == "control_run":
            found = stand_in_numbers(cell, seed, device,
                                     cell.config["control"], detail=detail)
        else:
            found = stand_in_numbers(cell, seed, device, fault="half_batch",
                                     detail=detail)
        out[kind][str(seed)] = found
        out["detail"][f"{kind} {seed}"] = detail
        print(f"{kind} seed {seed}: {found} ({time.perf_counter() - t:.1f} s)"
              f"\n  {detail}", flush=True)
    for kind in ("program", "control_run", "half_batch", "unchanged"):
        rows = list(out[kind].values())
        if rows:
            print(kind, {k: (min(r[k] for r in rows), max(r[k] for r in rows))
                         for k in rows[0]}, flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
