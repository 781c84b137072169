"""Weight bridge between the JAX package's flax parameter tree and the port's modules.

The port names its submodules after the flax tree, so every flax leaf maps to
one torch parameter:

* ``Dense`` (``nn.Linear``): kernel (in, out) -> weight (out, in), bias as is;
* ``Conv`` (``nn.Conv2d``): kernel (kh, kw, in/g, out) -> weight (out, in/g, kh, kw);
* ``Conv1`` (``nn.Conv1d``): kernel (k, in/g, out) -> weight (out, in/g, k);
* ``nn.LayerNorm`` and ``BatchNorm``: scale -> weight, bias as is;
* ``Bilinear`` (``nn.Bilinear``): weight (out, in1, in2) and bias as they are;
* raw parameters (``CPB2D``'s and ``CPB1D``'s w0 ... b2, ``cls_token``): same
  name, same shape.

The ``batch_stats`` collection (a BatchNorm's ``mean`` and ``var``) maps to
the BatchNorm's ``running_mean`` and ``running_var`` buffers.  A variables
tree is ``{"params": ..., "batch_stats": ...}``; in a flat ``'/'``-keyed dict
the statistics sit under ``batch_stats/`` beside the parameters' keys (the
``.npz`` layout ``train/loop.py:save_weights`` writes).

This is the inverse of the torch -> flax layout of
``sml_tpu/utils/torch_compat.py``, kept here as its own copy.  A flax leaf
with no torch tensor, or a torch tensor with no flax leaf, raises.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn


def flatten_params(tree: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict -> {'a/b/c': array}."""
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict) or hasattr(v, "items"):
            flat.update(flatten_params(v, key + "/"))
        else:
            flat[key] = np.asarray(v)
    return flat


def unflatten_params(flat: Dict[str, np.ndarray]) -> Dict:
    """{'a/b/c': array} -> nested dict."""
    tree: Dict = {}
    for key, v in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.asarray(v)
    return tree


STATS = "batch_stats/"
_BN_STATS = {"running_mean": "mean", "running_var": "var"}


def _leaf_map(model: nn.Module):
    """{flax key: (torch parameter, to_torch, to_flax)} for every parameter."""
    ident = (lambda a: a, lambda a: a)
    lin = (lambda a: a.T, lambda a: a.T)
    conv = (lambda a: a.transpose(3, 2, 0, 1), lambda a: a.transpose(2, 3, 1, 0))
    conv1 = (lambda a: a.transpose(2, 1, 0), lambda a: a.transpose(2, 1, 0))
    out = {}
    for mname, module in model.named_modules():
        base = mname.replace(".", "/")
        for pname, p in module.named_parameters(recurse=False):
            if isinstance(module, nn.Linear) and pname == "weight":
                leaf, fns = "kernel", lin
            elif isinstance(module, nn.Conv2d) and pname == "weight":
                leaf, fns = "kernel", conv
            elif isinstance(module, nn.Conv1d) and pname == "weight":
                leaf, fns = "kernel", conv1
            elif isinstance(module, (nn.LayerNorm, nn.BatchNorm1d)) and pname == "weight":
                leaf, fns = "scale", ident
            else:
                leaf, fns = pname, ident
            out[f"{base}/{leaf}" if base else leaf] = (p, *fns)
    return out


def _stats_map(model: nn.Module):
    """{flax batch_stats key: BatchNorm buffer} for every running average."""
    return {f"{mname.replace('.', '/')}/{_BN_STATS[bname]}": buf
            for mname, module in model.named_modules()
            if isinstance(module, nn.BatchNorm1d)
            for bname, buf in module.named_buffers(recurse=False) if bname in _BN_STATS}


def _fill(tensors: Dict[str, torch.Tensor], flat: Dict[str, np.ndarray], what: str,
          to_torch=None) -> None:
    missing = sorted(set(tensors) - set(flat))
    unused = sorted(set(flat) - set(tensors))
    if missing or unused:
        raise ValueError(f"flax {what} do not match the model: missing {missing}, "
                         f"unused {unused}")
    with torch.no_grad():
        for key, t in tensors.items():
            value = flat[key] if to_torch is None else to_torch[key](flat[key])
            value = torch.from_numpy(np.array(value))
            if value.shape != t.shape:
                raise ValueError(f"{key}: flax shape {tuple(value.shape)} -> torch "
                                 f"{tuple(t.shape)} expected")
            t.copy_(value.to(t.dtype))


def load_flax_params(model: nn.Module, variables: Dict) -> None:
    """Fill ``model`` from a flax ``variables['params']`` tree, or from a whole
    ``{"params", "batch_stats"}`` variables tree (arrays or nested dicts of
    arrays, or an already flat '/'-keyed dict, its statistics under
    ``batch_stats/``)."""
    flat = flatten_params(variables)
    if any(k.startswith("params/") for k in flat):
        params = {k[len("params/"):]: v for k, v in flat.items() if k.startswith("params/")}
    else:
        params = {k: v for k, v in flat.items() if not k.startswith(STATS)}
    stats = {k[len(STATS):]: v for k, v in flat.items() if k.startswith(STATS)}
    leaves = _leaf_map(model)
    _fill({k: p for k, (p, _, _) in leaves.items()}, params, "parameters",
          {k: to_torch for k, (_, to_torch, _) in leaves.items()})
    _fill(_stats_map(model), stats, "batch_stats")


def export_flax_params(model: nn.Module) -> Dict:
    """The model's parameters as a nested flax-layout tree of numpy arrays."""
    flat = {key: np.ascontiguousarray(to_flax(p.detach().float().cpu().numpy()))
            for key, (p, _, to_flax) in _leaf_map(model).items()}
    return unflatten_params(flat)


def export_flax_batch_stats(model: nn.Module) -> Dict:
    """The BatchNorms' running averages as a nested flax ``batch_stats`` tree
    ({} for a model without BatchNorm)."""
    return unflatten_params({k: b.detach().float().cpu().numpy()
                             for k, b in _stats_map(model).items()})


def load_npz(model: nn.Module, path: str) -> None:
    """Load an ``.npz`` of the flattened flax param tree ('/'-joined keys; a
    BatchNorm's statistics under ``batch_stats/``)."""
    with np.load(path) as data:
        load_flax_params(model, {k: data[k] for k in data.files})
