"""Reference (flax) parameters -> the port's PyTorch state dict.

``params_from_flax`` takes the reference's parameter tree as nested dicts of
numpy arrays — ``params/encoder/conv_{i}/...`` for a ``LinkPredictionGNN``,
or ``conv_{i}/...`` for a bare ``GNNEncoder`` — and returns the state dict
of the matching port module. Per conv: ``Dense`` subtrees ``lin_self``,
``lin_nbr`` (SAGE), ``lin`` (GCN), ``lin_src``, ``lin_dst`` (GAT),
``lin_q``, ``lin_k``, ``lin_v``, ``lin_skip`` (Transformer), ``lin_edge``
(EdgeAttrGAT, the Transformer with edges) and GIN's / GINE's
``mlp/layers_0``, ``mlp/layers_2`` (-> ``mlp.0``, ``mlp.2``); array leaves
``att``, ``att_src``, ``att_dst`` ``[H, Dh]``, ``bias`` and GIN's scalar
``eps``, copied as they are. Beside the convs, the encoder's
``edge_in_proj`` and the model's ``edge_scorer`` (``e0``, ``e1``) are
``Dense`` layers of the same names. A flax ``Dense`` kernel is ``[in,
out]``; an ``nn.Linear.weight`` is ``[out, in]``.

The encoder's options: ``bn_{i}`` (``scale``, ``bias``; with the tree's
``batch_stats`` collection, ``mean`` and ``var``, into the port's
buffers) -> ``bns.{i}``; ``jk/proj``, ``jk/att`` and the LSTM cells
``jk/OptimizedLSTMCell_0`` (the forward one, built first) and ``_1`` ->
``jk.lstm_fwd`` / ``jk.lstm_bwd`` (gates ``ii`` ... ``ho`` as they are);
``final_linear``; ``dcn/cross_{i}``; ``feature_embedding/embed_col{c}/
embedding``. Beside the encoder: the MLP decoders' ``decoder/mlp0``,
``mlp1``; a head subtree ``head`` (the link task's ``Dense_0``,
``Dense_1``; the SSL heads' ``proj/fc{1,2}``, ``predictor/fc{1,2}``,
``dec1``, ``dec2``), or such a head tree alone. A subtree that is itself
a variables dict (``{"params": ..., "batch_stats": ...}``, as the SSL
trainer's ``{"encoder": ..., "head": ...}`` holds them) is unwrapped.
``adam_state_from_optax`` maps an optax Adam state
(``ScaleByAdamState(count, mu, nu)``, whose moments are trees of the
params' structure) to the per-parameter state of a ``torch.optim.Adam``
over ``model.parameters()``, so both packages can start from one mid-run
state.

Typed trees (a ``HeteroGNNEncoder``'s, recognised by its ``in_{type}``
input projections, bare or under ``encoder`` as a
``HeteroLinkPredictionGNN``'s) map one to one: the port's typed modules
register their layers and arrays under flax's names (``in_{type}``,
``out_proj``, ``conv_{i}`` -> ``convs.{i}``, and in a conv ``k_{type}``,
``watt_{edge type}``, ``w``, ``basis_{b}``, ``edge_emb`` ...), so every
``Dense`` subtree becomes ``{name}.weight`` (transposed) and ``.bias``,
and every array leaf the parameter of the same name.

Tables and state beside the parameters: ``quantized_table_from_jax`` builds
a :class:`~gigl_tpu_torch.ops.quantized.QuantizedTable` from the
reference's ``q`` (int32-packed rows, unpacked little-endian as the
reference unpacks them, or int8 rows) and ``scale``; ``cms_from_jax`` a
:class:`~gigl_tpu_torch.losses.count_min_sketch.CountMinSketch` from its
table and total. Both take numpy arrays, so the two packages can start from
the same tables and the same sketch.

``sharded_params_from_jax`` takes the reference's
``ShardedFullBatchTrainer`` parameters (a list of ``{"w", "b"}`` or
``{"w_self", "w_nbr", "b"}`` arrays, ``[in, out]`` matrices used as ``h @
w``, not flax ``Dense`` layers) and returns the port trainer's state dict
(``layers.{i}.{name}``, the matrices as they are).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from gigl_tpu_torch.device import DeviceLike, resolve_device
from gigl_tpu_torch.losses.count_min_sketch import CountMinSketch
from gigl_tpu_torch.ops.quantized import QuantizedTable

_CONV = re.compile(r"conv_(\d+)$")
_BN = re.compile(r"bn_(\d+)$")
_LSTM = {"OptimizedLSTMCell_0": "lstm_fwd", "OptimizedLSTMCell_1": "lstm_bwd"}
_LSTM_GATES = ("ii", "if", "ig", "io", "hi", "hf", "hg", "ho")
# head subtrees: the link task's classifier, the SSL heads' layers
_HEADS = ("Dense_0", "Dense_1", "proj", "predictor", "dec1", "dec2")
_HEAD_LAYERS = ("fc1", "fc2")
_LINEARS = ("lin_self", "lin_nbr", "lin", "lin_src", "lin_dst", "lin_q",
            "lin_k", "lin_v", "lin_skip", "lin_edge")
_ARRAYS = ("att", "att_src", "att_dst", "bias", "eps")
_MLP = re.compile(r"layers_(\d+)$")


def _dense(leaves: Mapping[str, Any], key: str, where: str,
           out: Dict[str, torch.Tensor]) -> None:
    for leaf, value in leaves.items():
        a = torch.tensor(np.asarray(value, np.float32))
        if leaf == "kernel":
            out[f"{key}.weight"] = a.T.contiguous()
        elif leaf == "bias":
            out[f"{key}.bias"] = a
        else:
            raise ValueError(f"unsupported leaf {where}/{leaf}")


def _array(value) -> torch.Tensor:
    return torch.tensor(np.asarray(value, np.float32))


def _leaves(sub: Mapping[str, Any], names, key: str, where: str,
            out: Dict[str, torch.Tensor]) -> None:
    for leaf, value in sub.items():
        if leaf not in names:
            raise ValueError(f"unsupported leaf {where}/{leaf}")
        out[f"{key}.{leaf}"] = _array(value)


def _options(name: str, sub: Mapping[str, Any], stats: Mapping[str, Any],
             prefix: str, out: Dict[str, torch.Tensor]) -> bool:
    """One of the encoder's option subtrees (module docstring) into
    ``out``; False when ``name`` is none of them."""
    m = _BN.match(name)
    if m is not None:
        key = f"{prefix}bns.{m.group(1)}"
        _leaves(sub, ("scale", "bias"), key, name, out)
        _leaves(stats.get(name, {}), ("mean", "var"), key, name, out)
    elif name in ("final_linear",):
        _dense(sub, f"{prefix}{name}", name, out)
    elif name == "dcn":
        for layer, lv in sub.items():
            if not re.match(r"cross_\d+$", layer):
                raise ValueError(f"unsupported dcn parameter {layer!r}")
            _dense(lv, f"{prefix}dcn.{layer}", f"dcn/{layer}", out)
    elif name == "feature_embedding":
        for table, lv in sub.items():
            if not re.match(r"embed_col\d+$", table):
                raise ValueError(f"unsupported feature_embedding parameter "
                                 f"{table!r}")
            _leaves(lv, ("embedding",), f"{prefix}feature_embedding.{table}",
                    f"feature_embedding/{table}", out)
    elif name == "jk":
        for part, lv in sub.items():
            if part in ("proj", "att"):
                _dense(lv, f"{prefix}jk.{part}", f"jk/{part}", out)
            elif part in _LSTM:
                for gate, gv in lv.items():
                    if gate not in _LSTM_GATES:
                        raise ValueError(
                            f"unsupported LSTM parameter jk/{part}/{gate}")
                    _dense(gv, f"{prefix}jk.{_LSTM[part]}.{gate}",
                           f"jk/{part}/{gate}", out)
            else:
                raise ValueError(f"unsupported jk parameter {part!r}")
    else:
        return False
    return True


def _head(tree: Mapping[str, Any], prefix: str) -> Dict[str, torch.Tensor]:
    """A head subtree: ``Dense_{0,1}``, ``dec{1,2}`` or a projector
    ``proj`` / ``predictor`` of ``fc1``, ``fc2``."""
    out: Dict[str, torch.Tensor] = {}
    for name, sub in tree.items():
        if name not in _HEADS:
            raise ValueError(f"unsupported head parameter {name!r}")
        if name in ("proj", "predictor"):
            for layer, lv in sub.items():
                if layer not in _HEAD_LAYERS:
                    raise ValueError(
                        f"unsupported head parameter {name}/{layer}")
                _dense(lv, f"{prefix}{name}.{layer}", f"{name}/{layer}", out)
        else:
            _dense(sub, f"{prefix}{name}", name, out)
    return out


def _convs(tree: Mapping[str, Any], prefix: str,
           stats: Optional[Mapping[str, Any]] = None
           ) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for name, sub in tree.items():
        if name == "edge_in_proj":
            _dense(sub, f"{prefix}edge_in_proj", name, out)
            continue
        if _options(name, sub, stats or {}, prefix, out):
            continue
        m = _CONV.match(name)
        if m is None:
            raise ValueError(f"unsupported encoder parameter {name!r}")
        conv = f"{prefix}convs.{m.group(1)}"
        for part, leaves in sub.items():
            if part in _LINEARS:
                _dense(leaves, f"{conv}.{part}", f"{name}/{part}", out)
            elif part in _ARRAYS:
                out[f"{conv}.{part}"] = torch.tensor(
                    np.asarray(leaves, np.float32))
            elif part == "mlp":
                for layer, lv in leaves.items():
                    lm = _MLP.match(layer)
                    if lm is None:
                        raise ValueError(
                            f"unsupported conv parameter {name}/mlp/{layer}")
                    _dense(lv, f"{conv}.mlp.{lm.group(1)}",
                           f"{name}/mlp/{layer}", out)
            else:
                raise ValueError(f"unsupported conv parameter {name}/{part}")
    return out


def _typed(tree: Mapping[str, Any], prefix: str) -> Dict[str, torch.Tensor]:
    """A typed tree under flax's names (see the module docstring)."""
    out: Dict[str, torch.Tensor] = {}
    for name, sub in tree.items():
        m = _CONV.match(name)
        key = f"{prefix}convs.{m.group(1)}" if m else f"{prefix}{name}"
        if isinstance(sub, Mapping) and "kernel" in sub:
            _dense(sub, key, name, out)
        elif isinstance(sub, Mapping):
            out.update(_typed(sub, f"{key}."))
        else:
            out[key] = torch.tensor(np.asarray(sub, np.float32))
    return out


def _encoder(tree: Mapping[str, Any], prefix: str,
             stats: Optional[Mapping[str, Any]] = None
             ) -> Dict[str, torch.Tensor]:
    if any(k.startswith("in_") for k in tree):
        return _typed(tree, prefix)
    return _convs(tree, prefix, stats)


def _unwrap(tree: Mapping[str, Any]):
    """(params, batch_stats) of a variables dict, or (tree, {})."""
    if "params" in tree:
        return tree["params"], tree.get("batch_stats", {})
    return tree, {}


def params_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """State dict for a ``LinkPredictionGNN`` or ``HeteroLinkPredictionGNN``
    (tree with an ``encoder`` subtree; with ``head`` instead of
    ``decoder``: a ``LinkClassificationModel`` or the SSL trainer's
    model), a ``GNNEncoder`` (tree of ``conv_{i}`` subtrees), a
    ``HeteroGNNEncoder`` or a head alone (module docstring)."""
    tree, stats = _unwrap(tree)
    if "encoder" in tree:
        extra = set(tree) - {"encoder", "decoder", "edge_scorer", "head"}
        if extra:
            raise ValueError(f"unsupported model parameters {sorted(extra)}")
        enc, enc_stats = _unwrap(tree["encoder"])
        out = _encoder(enc, "encoder.", {**stats.get("encoder", {}),
                                         **enc_stats})
        for name in ("decoder", "edge_scorer"):
            for layer, leaves in tree.get(name, {}).items():
                if name == "decoder" and layer not in ("mlp0", "mlp1"):
                    raise ValueError(
                        f"unsupported decoder parameter {layer!r}")
                _dense(leaves, f"{name}.{layer}", f"{name}/{layer}", out)
        if "head" in tree:
            out.update(_head(_unwrap(tree["head"])[0], "head."))
        return out
    if tree and set(tree) <= set(_HEADS):
        return _head(tree, "")
    return _encoder(tree, "", stats)


def _find_adam_state(state: Any) -> Optional[Any]:
    """The first node of an optax state tree with ``count``, ``mu`` and
    ``nu`` (a ``ScaleByAdamState``), found without importing optax."""
    if all(hasattr(state, a) for a in ("count", "mu", "nu")):
        return state
    if isinstance(state, (tuple, list)):
        for sub in state:
            found = _find_adam_state(sub)
            if found is not None:
                return found
    return None


def adam_state_from_optax(opt_state: Any, model: torch.nn.Module
                          ) -> Dict[int, Dict[str, torch.Tensor]]:
    """The ``"state"`` entry of a ``torch.optim.Adam`` state dict whose
    parameters are ``list(model.parameters())``, from an optax Adam state:
    ``step`` = count, ``exp_avg`` = mu, ``exp_avg_sq`` = nu. Load it with
    ``opt.load_state_dict({"state": ..., "param_groups":
    opt.state_dict()["param_groups"]})``."""
    adam = _find_adam_state(opt_state)
    if adam is None:
        raise ValueError("no ScaleByAdamState (count, mu, nu) in opt_state")
    mu, nu = params_from_flax(adam.mu), params_from_flax(adam.nu)
    names = [name for name, _ in model.named_parameters()]
    if set(mu) != set(names):
        raise ValueError(f"optax moments {sorted(mu)} do not match the "
                         f"model's parameters {sorted(names)}")
    step = float(np.asarray(adam.count))
    return {i: {"step": torch.tensor(step, dtype=torch.float32),
                "exp_avg": mu[name], "exp_avg_sq": nu[name]}
            for i, name in enumerate(names)}


def quantized_table_from_jax(q: np.ndarray, scale: np.ndarray, dim: int,
                             out_dtype: torch.dtype = torch.float32,
                             device: DeviceLike = None) -> QuantizedTable:
    """The reference's ``QuantizedTable`` (``q`` [N, D/4] int32-packed or
    [N, D] int8, ``scale`` [N, 1] fp32, its ``dim``) as the port's int8
    table on ``device`` (CUDA unless given)."""
    q = np.ascontiguousarray(np.asarray(q))
    n = q.shape[0]
    if q.dtype == np.int32:
        q = q.view(np.int8).reshape(n, -1)   # little-endian bytes, in order
    if q.dtype != np.int8 or q.shape != (n, dim):
        raise ValueError(f"q must be int32-packed or int8 rows of {dim} "
                         f"values, got {q.dtype} {q.shape}")
    device = resolve_device(device)
    return QuantizedTable(
        q=torch.from_numpy(q.copy()).to(device),
        scale=torch.from_numpy(np.asarray(scale, np.float32).reshape(n, 1)
                               .copy()).to(device),
        out_dtype=out_dtype)


def cms_from_jax(table: np.ndarray, total, device: DeviceLike = None
                 ) -> CountMinSketch:
    """The reference's ``CountMinSketch`` (table [depth, width] int32, total
    int32) on ``device`` (CUDA unless given)."""
    device = resolve_device(device)
    return CountMinSketch(
        table=torch.from_numpy(np.asarray(table, np.int32).copy()).to(device),
        total=torch.tensor(int(np.asarray(total)), dtype=torch.int32,
                           device=device))


def sharded_params_from_jax(params) -> Dict[str, torch.Tensor]:
    """The reference's sharded full-batch parameters (a list of per-layer
    dicts of arrays) as the state dict of the port's
    ``ShardedFullBatchTrainer.model``: ``layers.{i}.{name}``, fp32, the
    ``[in, out]`` matrices untransposed."""
    out = {}
    for i, layer in enumerate(params):
        for name, value in layer.items():
            out[f"layers.{i}.{name}"] = torch.from_numpy(
                np.array(value, dtype=np.float32))
    return out
