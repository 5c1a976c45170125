"""TransformerNet's configuration and long-unroll mix
(``transformer_d128.json`` beside this file), which no cell runs: no
public source bears out these widths. The family's code stays, and
these tests hold it to the port, so that a cell of a sourced
configuration needs only data files."""

import json
from pathlib import Path

from cellbench.lookup import Cell

_DATA = json.loads(Path(__file__).with_name("transformer_d128.json")
                   .read_text())


class PendingCell(Cell):
    """A cell of the pending configuration and mix, with no limits and
    no metrics of ``BENCHMARK.json``."""

    def __init__(self):
        self.name = "transformer_learn_t2048"
        self.config = dict(_DATA["config"])
        self.traffic = dict(_DATA["traffic"])
        self.limits = {}
        self.chips = 1
        self.end_to_end, self.per_layer = [], []


def cell(name: str) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``, or the pending one."""
    return PendingCell() if name == "transformer_learn_t2048" else Cell(name)
