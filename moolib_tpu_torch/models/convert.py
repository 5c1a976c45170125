"""Reference (flax) parameters -> the port's ``state_dict``.

Takes the reference's parameter tree with numpy leaves (call
``np.asarray`` on device arrays first, or pass them as they are: any leaf
that converts with ``np.asarray`` works) and returns CPU tensors keyed as
the port's modules name them.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

__all__ = ["a2c_params_from_flax", "impala_params_from_flax",
           "nethack_params_from_flax", "transformer_params_from_flax"]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _dense(p: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Dense kernel [in, out] -> Linear weight [out, in]."""
    out = {"weight": _t(p["kernel"]).T.contiguous()}
    if "bias" in p:
        out["bias"] = _t(p["bias"])
    return out


def _conv(p: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Conv kernel [kh, kw, cin, cout] -> Conv2d weight [cout, cin, kh, kw]."""
    return {"weight": _t(p["kernel"]).permute(3, 2, 0, 1).contiguous(),
            "bias": _t(p["bias"])}


def _norm(p: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """LayerNorm scale/bias -> weight/bias."""
    return {"weight": _t(p["scale"]), "bias": _t(p["bias"])}


def transformer_params_from_flax(params: Mapping[str, Any]
                                 ) -> Dict[str, torch.Tensor]:
    """Map a ``TransformerNet`` parameter tree (``{"params": ...}`` or its
    inside) onto :class:`moolib_tpu_torch.models.TransformerNet`'s
    ``state_dict`` keys; an MoE block's ``moe/{router,w_up,w_down}``
    keep their layout. Raises ``KeyError`` on a tree of another model,
    and on one that mixes dense and MoE blocks (the port's blocks are all
    of one kind), or a block that has both MLPs."""
    p = params["params"] if "params" in params else params
    sd: Dict[str, torch.Tensor] = {}

    def put(prefix: str, tensors: Dict[str, torch.Tensor]):
        for k, v in tensors.items():
            sd[f"{prefix}.{k}"] = v

    if "Conv_0" in p:
        put("conv0", _conv(p["Conv_0"]))
        put("conv1", _conv(p["Conv_1"]))
    else:
        put("embed_in", _dense(p["Dense_0"]))
    sd["pos_emb.weight"] = _t(p["pos_emb"]["embedding"])
    kinds = set()
    i = 0
    while f"block_{i}" in p:
        blk = p[f"block_{i}"]
        pre = f"blocks.{i}"
        put(f"{pre}.ln1", _norm(blk["LayerNorm_0"]))
        put(f"{pre}.attn.qkv", _dense(blk["attn"]["qkv"]))
        put(f"{pre}.attn.out", _dense(blk["attn"]["out"]))
        put(f"{pre}.ln2", _norm(blk["LayerNorm_1"]))
        if "moe" in blk:
            if "Dense_0" in blk or "Dense_1" in blk:
                raise KeyError(f"block_{i} has both a dense MLP and an "
                               "MoE MLP")
            put(f"{pre}.moe", {k: _t(blk["moe"][k])
                               for k in ("router", "w_up", "w_down")})
            kinds.add("moe")
        else:
            put(f"{pre}.mlp_in", _dense(blk["Dense_0"]))
            put(f"{pre}.mlp_out", _dense(blk["Dense_1"]))
            kinds.add("dense")
        i += 1
    if len(kinds) > 1:
        raise KeyError("the tree mixes dense and MoE blocks; the port's "
                       "TransformerNet has blocks of one kind")
    put("ln_f", _norm(p["LayerNorm_0"]))
    put("policy", _dense(p["policy"]))
    put("baseline", _dense(p["baseline"]))
    return sd


def _lstm_cell(cell: Mapping[str, Any], prefix: str
               ) -> Dict[str, torch.Tensor]:
    """A flax ``OptimizedLSTMCell``'s kernels (gates i, f, g, o) ->
    :class:`~moolib_tpu_torch.models.LSTMCore`'s ``weight_ih`` (``ii``..
    ``io``, no bias), ``weight_hh`` and ``bias_hh`` (``hi``..``ho``)."""

    def stacked(side: str, leaf: str) -> torch.Tensor:
        return torch.cat([_t(cell[side + g][leaf]) for g in "ifgo"], dim=-1)

    return {f"{prefix}.weight_ih": stacked("i", "kernel").T.contiguous(),
            f"{prefix}.weight_hh": stacked("h", "kernel").T.contiguous(),
            f"{prefix}.bias_hh": stacked("h", "bias")}


def a2c_params_from_flax(params: Mapping[str, Any]
                         ) -> Dict[str, torch.Tensor]:
    """Map an ``A2CNet`` parameter tree (``{"params": ...}`` or its
    inside) onto :class:`moolib_tpu_torch.models.A2CNet`'s ``state_dict``
    keys: the hidden ``Dense_i`` -> ``hidden.i``, the last two Dense
    layers -> ``policy`` and ``baseline``, and ``LSTMCore_0``'s cell ->
    ``core``. Raises ``KeyError`` on a tree of another model."""
    p = params["params"] if "params" in params else params
    sd: Dict[str, torch.Tensor] = {}
    dense = sorted((k for k in p if k.startswith("Dense_")),
                   key=lambda k: int(k.split("_")[1]))
    *hidden, policy, baseline = dense
    for i, k in enumerate(hidden):
        for leaf, v in _dense(p[k]).items():
            sd[f"hidden.{i}.{leaf}"] = v
    for name, k in (("policy", policy), ("baseline", baseline)):
        for leaf, v in _dense(p[k]).items():
            sd[f"{name}.{leaf}"] = v
    if "LSTMCore_0" in p:
        sd.update(_lstm_cell(
            p["LSTMCore_0"]["Scan_MaskedLSTMStep_0"]["OptimizedLSTMCell_0"],
            "core"))
    return sd


def impala_params_from_flax(params: Mapping[str, Any]
                            ) -> Dict[str, torch.Tensor]:
    """Map an ``ImpalaNet`` parameter tree (``{"params": ...}`` or its
    inside) onto :class:`moolib_tpu_torch.models.ImpalaNet`'s
    ``state_dict`` keys: ``ConvSequence_i`` -> ``sequences.i`` (its
    ``Conv_0`` -> ``conv``, ``ResidualBlock_j/Conv_k`` -> ``resj.convk``),
    ``Dense_0`` -> ``fc`` (both flatten in (h, w, c) order), ``Dense_1``
    -> ``policy``, ``Dense_2`` -> ``baseline``, and the LSTM cell's
    kernels (gates i, f, g, o) -> ``core.weight_ih`` (``ii``..``io``, no
    bias), ``core.weight_hh`` and ``core.bias_hh`` (``hi``..``ho``).
    Raises ``KeyError`` on a tree of another model."""
    p = params["params"] if "params" in params else params
    sd: Dict[str, torch.Tensor] = {}

    def put(prefix: str, tensors: Dict[str, torch.Tensor]):
        for k, v in tensors.items():
            sd[f"{prefix}.{k}"] = v

    i = 0
    while f"ConvSequence_{i}" in p:
        seq = p[f"ConvSequence_{i}"]
        put(f"sequences.{i}.conv", _conv(seq["Conv_0"]))
        for j in range(2):
            for k in range(2):
                put(f"sequences.{i}.res{j}.conv{k}",
                    _conv(seq[f"ResidualBlock_{j}"][f"Conv_{k}"]))
        i += 1
    put("fc", _dense(p["Dense_0"]))
    put("policy", _dense(p["Dense_1"]))
    put("baseline", _dense(p["Dense_2"]))
    if "LSTMCore_0" in p:
        sd.update(_lstm_cell(
            p["LSTMCore_0"]["Scan_MaskedLSTMStep_0"]["OptimizedLSTMCell_0"],
            "core"))
    return sd


def nethack_params_from_flax(params: Mapping[str, Any]
                             ) -> Dict[str, torch.Tensor]:
    """Map a ``NetHackNet`` parameter tree (``{"params": ...}`` or its
    inside) onto :class:`moolib_tpu_torch.models.NetHackNet`'s
    ``state_dict`` keys: ``glyph_embed``, ``Conv_i`` -> ``convs.i``,
    ``Dense_0`` -> ``blstats_fc``, ``Dense_1`` -> ``fc`` (both flatten
    the glyph features in (h, w, c) order), the heads, and the LSTM cell
    -> ``core``. Raises ``KeyError`` on a tree of another model."""
    p = params["params"] if "params" in params else params
    sd: Dict[str, torch.Tensor] = {
        "glyph_embed.weight": _t(p["glyph_embed"]["embedding"])}
    for i in range(3):
        for leaf, v in _conv(p[f"Conv_{i}"]).items():
            sd[f"convs.{i}.{leaf}"] = v
    for name, k in (("blstats_fc", "Dense_0"), ("fc", "Dense_1"),
                    ("policy", "policy"), ("baseline", "baseline")):
        for leaf, v in _dense(p[k]).items():
            sd[f"{name}.{leaf}"] = v
    if "LSTMCore_0" in p:
        sd.update(_lstm_cell(
            p["LSTMCore_0"]["Scan_MaskedLSTMStep_0"]["OptimizedLSTMCell_0"],
            "core"))
    return sd
