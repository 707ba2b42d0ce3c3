"""Reference (flax) parameters -> the port's PyTorch state dict.

``params_from_flax`` takes the reference's parameter tree as nested dicts of
numpy arrays — ``params/encoder/conv_{i}/lin_self/{kernel,bias}`` and
``.../lin_nbr/kernel`` for a ``LinkPredictionGNN``, or ``conv_{i}/...`` for
a bare ``GNNEncoder`` — and returns the state dict of the matching port
module. A flax ``Dense`` kernel is ``[in, out]``; an ``nn.Linear.weight``
is ``[out, in]``.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

_CONV = re.compile(r"conv_(\d+)$")
_LINEARS = ("lin_self", "lin_nbr")


def _convs(tree: Mapping[str, Any], prefix: str) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for name, sub in tree.items():
        m = _CONV.match(name)
        if m is None:
            raise ValueError(f"unsupported encoder parameter {name!r}")
        for lin, leaves in sub.items():
            if lin not in _LINEARS:
                raise ValueError(f"unsupported conv parameter {name}/{lin}")
            key = f"{prefix}convs.{m.group(1)}.{lin}"
            for leaf, value in leaves.items():
                a = torch.tensor(np.asarray(value, np.float32))
                if leaf == "kernel":
                    out[f"{key}.weight"] = a.T.contiguous()
                elif leaf == "bias":
                    out[f"{key}.bias"] = a
                else:
                    raise ValueError(f"unsupported leaf {name}/{lin}/{leaf}")
    return out


def params_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """State dict for a ``LinkPredictionGNN`` (tree with an ``encoder``
    subtree) or a ``GNNEncoder`` (tree of ``conv_{i}`` subtrees)."""
    if "params" in tree:
        tree = tree["params"]
    if "encoder" in tree:
        extra = set(tree) - {"encoder", "decoder"}
        if extra or tree.get("decoder"):
            raise ValueError(f"unsupported model parameters {sorted(extra)}")
        return _convs(tree["encoder"], "encoder.")
    return _convs(tree, "")
