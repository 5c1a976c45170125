"""Terminal plotter for run logs; the counterpart of
:mod:`moolib_tpu.examples.plot`, with byte-identical output on the same
``logs.tsv``.

Dependency-free: renders a unicode braille scatter of any ``logs.tsv``
column against ``env_steps``. The elastic soak reads peers' progress
through :func:`read_tsv`.

Usage:
    python -m moolib_tpu_torch.examples.plot SAVEDIR [--y episode_returns] \
        [--x env_steps] [--width 100] [--height 24]
"""

from __future__ import annotations

import argparse
import math
import os
import sys
from typing import List, Tuple

__all__ = ["read_tsv", "render"]

_BRAILLE_BASE = 0x2800
# Braille dot bit for (row 0-3, col 0-1) within a cell.
_DOT = [[0x01, 0x08], [0x02, 0x10], [0x04, 0x20], [0x40, 0x80]]


def read_tsv(path: str) -> List[dict]:
    rows = []
    with open(path) as f:
        header = f.readline().strip().split("\t")
        for line in f:
            parts = line.rstrip("\n").split("\t")
            row = {}
            for k, v in zip(header, parts):
                try:
                    row[k] = float(v)
                except ValueError:
                    row[k] = v
            rows.append(row)
    return rows


def render(
    points: List[Tuple[float, float]],
    width: int = 100,
    height: int = 24,
    x_label: str = "x",
    y_label: str = "y",
) -> str:
    pts = [
        (x, y)
        for x, y in points
        if isinstance(x, float)
        and isinstance(y, float)
        and math.isfinite(x)
        and math.isfinite(y)
    ]
    if not pts:
        return "(no finite data points)"
    xs, ys = zip(*pts)
    x0, x1 = min(xs), max(xs)
    y0, y1 = min(ys), max(ys)
    if x1 == x0:
        x1 = x0 + 1.0
    if y1 == y0:
        y1 = y0 + 1.0
    cols, rows = width, height
    grid = [[0] * cols for _ in range(rows)]
    for x, y in pts:
        px = (x - x0) / (x1 - x0) * (cols * 2 - 1)
        py = (1 - (y - y0) / (y1 - y0)) * (rows * 4 - 1)
        c, cx = divmod(int(px), 2)
        r, ry = divmod(int(py), 4)
        grid[r][c] |= _DOT[ry][cx]
    lines = []
    for r, row in enumerate(grid):
        mark = ""
        if r == 0:
            mark = f" {y1:.6g}"
        elif r == rows - 1:
            mark = f" {y0:.6g}"
        lines.append(
            "".join(
                chr(_BRAILLE_BASE + v) if v else " " for v in row
            ).rstrip()
            + mark
        )
    lines.append(f"{x0:.6g}{' ' * max(1, cols - 20)}{x1:.6g}")
    lines.append(f"[{y_label} vs {x_label}, {len(pts)} points]")
    return "\n".join(lines)


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("savedir", help="run directory containing logs.tsv "
                                   "(or a path to a .tsv file)")
    p.add_argument("--y", default="episode_returns")
    p.add_argument("--x", default="env_steps")
    p.add_argument("--width", type=int, default=100)
    p.add_argument("--height", type=int, default=24)
    args = p.parse_args()
    path = args.savedir
    if os.path.isdir(path):
        path = os.path.join(path, "logs.tsv")
    rows = read_tsv(path)
    if not rows:
        sys.exit("no rows in " + path)
    if args.y not in rows[0]:
        sys.exit(
            f"column {args.y!r} not in {sorted(rows[0])}"
        )
    pts = [(r.get(args.x), r.get(args.y)) for r in rows]
    print(render(pts, args.width, args.height, args.x, args.y))


if __name__ == "__main__":
    main()
