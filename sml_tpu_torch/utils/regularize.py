"""L1 weight regularisers (counterpart of ``sml_tpu/utils/regularize.py``;
reference ``utils/utils.py:34-173``).

Each returns a differentiable f32 scalar over a model's parameters.  A
parameter is named by its flax path (the weight bridge's map, ``bridge.
_leaf_map``), so the same names select the same leaves as in the JAX package.
"""

from __future__ import annotations

from typing import Iterable

import torch
from torch import nn

from sml_tpu_torch.bridge import _leaf_map


def regularize_weights(model: nn.Module) -> torch.Tensor:
    """L1 norm of every parameter."""
    return regularize_subtrees(model, ("",))


def regularize_subtrees(model: nn.Module, names: Iterable[str]) -> torch.Tensor:
    """L1 norm of the parameters whose flax path has a part containing any of
    ``names`` (a constant 0 when none has)."""
    names = tuple(names)
    terms = [p.float().abs().sum() for path, (p, _, _) in _leaf_map(model).items()
             if any(n in part for n in names for part in path.split("/"))]
    if not terms:
        return torch.zeros((), device=next(model.parameters()).device)
    return torch.stack(terms).sum()


def regularize_mm_weights(model: nn.Module) -> torch.Tensor:
    """Reference ``regularize_MM_weights``: omic net, fusion linears, encoders
    and classifier."""
    return regularize_subtrees(model, ("omic_net", "linear_h", "linear_z", "linear_o",
                                       "encoder", "classifier"))


def regularize_mm_omic(model: nn.Module) -> torch.Tensor:
    """Reference ``regularize_MM_omic``: the omic net's parameters only."""
    return regularize_subtrees(model, ("omic_net",))
