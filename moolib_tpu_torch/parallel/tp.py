"""Tensor parallelism: Megatron-sharded parameters over the ``tp`` axis;
the counterpart of :mod:`moolib_tpu.parallel.tp`.

The placements follow the reference's rules, read off the port's
parameter names and shapes (an ``nn.Linear`` weight is [out, in], the
transpose of flax's ``kernel``):

- attention qkv and MLP up-projections are column-parallel: the weight
  is ``Shard(0)`` (rank r holds output rows [r*out/tp, (r+1)*out/tp))
  and its bias shards with it;
- the attention output and MLP down-projections are row-parallel: the
  weight is ``Shard(1)`` (rank r holds input columns [r*in/tp,
  (r+1)*in/tp)) and the bias is replicated;
- everything else is replicated.

:func:`shard_params` places them as ``DTensor`` parameters on
``mesh["tp"]``. The reference's tp is pure placement and XLA inserts
the collectives; here the layers whose weight is sharded compute on
their local shards with :func:`column_linear` and :func:`row_linear`
(Megatron's f and g region operators around them), which
``TransformerNet`` and ``ImpalaNet`` call when they find a sharded
weight. The fused qkv weight's contiguous row shard cuts across q, k
and v (rank 0 of 2 holds all of q and half of k), so the attention
gathers the fused output before it splits it and takes its own heads.
"""

from __future__ import annotations

from collections import Counter
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from . import collectives

__all__ = [
    "transformer_tp_specs",
    "impala_tp_specs",
    "shard_params",
    "sharded_init_opt_state",
    "count_sharded_leaves",
    "column_linear",
    "row_linear",
    "is_sharded",
    "tp_group",
]


def _placements():
    from torch.distributed.tensor import Replicate, Shard

    return Shard(0), Shard(1), Replicate()


def _named(params) -> Dict[str, torch.Tensor]:
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def transformer_tp_specs(params) -> Dict[str, Any]:
    """Placements by parameter name for transformer-shaped parameters (a
    module or its ``{name: tensor}``), derived from shapes and tree
    structure, not layer names:

    - [k*d_model, d_model] weights (k > 1: the qkv fusion, MLP
      up-projections) are column-parallel, their bias with them;
    - [d_model, k*d_model] weights (MLP down-projections) row-parallel;
    - a square [d_model, d_model] weight is row-parallel iff a sibling at
      the same depth holds a wide column weight (the attention output
      beside its qkv);
    - a candidate counts only where its top-level block holds both a
      column and a row placement (a lone wide head replicates).

    d_model is the most common LayerNorm width (1-D ``weight`` leaves).
    Raises RuntimeError when no column or no row placement is found."""
    col, row, rep = _placements()
    named = _named(params)
    widths = [t.shape[-1] for n, t in named.items()
              if n.split(".")[-1] == "weight" and t.dim() == 1]
    if not widths:
        raise RuntimeError(
            "transformer_tp_specs: no LayerNorm weights found to infer "
            "d_model from; is this a transformer parameter tree?")
    d = Counter(widths).most_common(1)[0][0]
    weights = [(tuple(n.split(".")), tuple(t.shape)) for n, t in named.items()
               if n.split(".")[-1] == "weight" and t.dim() == 2]

    def classify(names, shape):
        fout, fin = shape
        if fin == d and fout > d and fout % d == 0:
            return "col"
        if fin > d and fout == d and fin % d == 0:
            return "row"
        if fin == d and fout == d:
            prefix, depth = names[:-2], len(names)
            for other, (oout, oin) in weights:
                if (other != names and len(other) == depth
                        and other[:-2] == prefix and oin == d
                        and oout >= 2 * d):
                    return "row"
        return None

    candidates = {names[:-1]: kind for names, shape in weights
                  if (kind := classify(names, shape)) is not None}
    by_block: dict = {}
    for parent, kind in candidates.items():
        by_block.setdefault(parent[:2], set()).add(kind)
    placement = {parent: kind for parent, kind in candidates.items()
                 if by_block[parent[:2]] == {"col", "row"}}
    n_col = sum(1 for k in placement.values() if k == "col")
    n_row = sum(1 for k in placement.values() if k == "row")
    if not n_col or not n_row:
        raise RuntimeError(
            f"transformer_tp_specs derived {n_col} column / {n_row} row "
            f"placements (d_model={d}); the tree has LayerNorms but no "
            "recognizable qkv/MLP projection shapes; tp would silently "
            "replicate. Check the model structure or write explicit specs.")

    def spec(name):
        names = tuple(name.split("."))
        kind = placement.get(names[:-1])
        if kind is None:
            return rep
        if names[-1] == "weight":
            return col if kind == "col" else row
        if names[-1] == "bias" and kind == "col":
            return col
        return rep

    return {n: spec(n) for n in named}


def impala_tp_specs(params) -> Dict[str, Any]:
    """Placements by parameter name for ImpalaNet-shaped parameters,
    derived from shapes: the widest fan-in linear weight (the conv
    flatten's projection) is column-parallel with its bias; the linear
    weights reading that hidden width and projecting down (the policy
    and baseline heads) row-parallel; convolutions and the LSTM
    replicate. Raises RuntimeError when neither can be recognized."""
    col, row, rep = _placements()
    named = _named(params)
    dense = [(tuple(n.split(".")), tuple(t.shape)) for n, t in named.items()
             if n.split(".")[-1] == "weight" and t.dim() == 2]
    if not dense:
        raise RuntimeError(
            "impala_tp_specs: no 2D dense weights found in the tree")
    flatten_names, (hidden, fan_in) = max(dense, key=lambda kv: kv[1][1])
    if fan_in <= 2 * hidden:
        raise RuntimeError(
            f"impala_tp_specs: widest dense fan-in {fan_in} is not "
            f"flatten-shaped (hidden={hidden}); cannot identify the "
            "column-parallel projection; tp would silently replicate.")
    heads = {names[:-1] for names, (fout, fin) in dense
             if fin == hidden and fout < hidden}
    if not heads:
        raise RuntimeError(
            f"impala_tp_specs: no head weights reading hidden={hidden} "
            "found; row-parallel placement would be empty.")
    col_parent = flatten_names[:-1]

    def spec(name):
        names = tuple(name.split("."))
        if names[:-1] == col_parent:
            return col
        if names[:-1] in heads and names[-1] == "weight":
            return row
        return rep

    return {n: spec(n) for n in named}


def count_sharded_leaves(specs: Dict[str, Any]) -> int:
    """Number of sharded placements: callers hold it against the count
    they expect, so a model change that stops matching the rules fails
    loudly instead of silently replicating."""
    return sum(1 for s in specs.values() if s.is_shard())


def _shard(mesh, t: torch.Tensor, placement):
    from torch.distributed.tensor import DTensor

    if placement.is_shard():
        n, r = mesh.size(), mesh.get_local_rank()
        if t.shape[placement.dim] % n:
            raise ValueError(f"dim {placement.dim} of {tuple(t.shape)} does "
                             f"not split {n} ways")
        local = t.detach().chunk(n, placement.dim)[r].contiguous()
    else:
        local = t.detach()
    return DTensor.from_local(local, mesh, [placement], run_check=False,
                              shape=t.shape, stride=t.stride())


def shard_params(mesh, params: torch.nn.Module, specs: Dict[str, Any],
                 axis: str = "tp") -> torch.nn.Module:
    """Place a module's parameters per ``specs`` on ``mesh[axis]``: each
    sharded one is replaced in place by a ``DTensor`` parameter holding
    this rank's shard. Every rank holds the same whole parameters (one
    seed, or :func:`~moolib_tpu_torch.learner.replicate_state`) and keeps
    its own shard: no data moves. Returns the module."""
    sub = mesh[axis] if mesh.ndim > 1 else mesh
    for name, p in list(params.named_parameters()):
        if not specs[name].is_shard():
            continue
        owner = params.get_submodule(name.rpartition(".")[0]) \
            if "." in name else params
        setattr(owner, name.rpartition(".")[2], torch.nn.Parameter(
            _shard(sub, p, specs[name]), requires_grad=p.requires_grad))
    return params


def sharded_init_opt_state(optimizer: torch.optim.Optimizer,
                           sharded_params=None):
    """Create the optimizer's state now, placed like each parameter (the
    state of a sharded parameter is its shard's): ``optax``'s ``init``
    under the reference's jit. ``optimizer`` is built over the sharded
    parameters; returns its state."""
    optimizer.init_state()
    return optimizer.state


def is_sharded(weight) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(weight, DTensor)


def tp_group(weight):
    """The process group of a sharded weight's (1-D) mesh."""
    return weight.device_mesh.get_group()


def _local(t: Optional[torch.Tensor]):
    return t.to_local() if t is not None and is_sharded(t) else t


def column_linear(x: torch.Tensor, weight, bias=None) -> torch.Tensor:
    """A column-parallel linear layer on replicated ``x``: this rank's
    output features (``weight`` ``Shard(0)``, ``bias`` with it)."""
    x = collectives.copy_to(x, tp_group(weight))
    return F.linear(x, weight.to_local(), _local(bias))


def row_linear(x: torch.Tensor, weight, bias=None) -> torch.Tensor:
    """A row-parallel linear layer on this rank's input features
    (``weight`` ``Shard(1)``): the ranks' partial products summed, then
    the replicated ``bias``."""
    y = collectives.reduce_from(F.linear(x, weight.to_local()),
                                tp_group(weight))
    return y if bias is None else y + bias
