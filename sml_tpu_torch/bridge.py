"""Weight bridge between the JAX package's flax parameter tree and the port's modules.

The port names its submodules after the flax tree, so every flax leaf maps to
one torch parameter:

* ``Dense`` (``nn.Linear``): kernel (in, out) -> weight (out, in), bias as is;
* ``Conv`` (``nn.Conv2d``): kernel (kh, kw, in/g, out) -> weight (out, in/g, kh, kw);
* ``nn.LayerNorm``: scale -> weight, bias as is;
* raw parameters (``CPB2D``'s w0 ... b2): same name, same shape.

This is the inverse of the torch -> flax layout of
``sml_tpu/utils/torch_compat.py``, kept here as its own copy.  A flax leaf
with no torch parameter, or a torch parameter with no flax leaf, raises.
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


def _leaf_map(model: nn.Module):
    """{flax key: (torch parameter, to_torch, to_flax)} for every parameter."""
    ident = (lambda a: a, lambda a: a)
    lin = (lambda a: a.T, lambda a: a.T)
    conv = (lambda a: a.transpose(3, 2, 0, 1), lambda a: a.transpose(2, 3, 1, 0))
    out = {}
    for mname, module in model.named_modules():
        base = mname.replace(".", "/")
        for pname, p in module.named_parameters(recurse=False):
            if isinstance(module, nn.Linear) and pname == "weight":
                leaf, fns = "kernel", lin
            elif isinstance(module, nn.Conv2d) and pname == "weight":
                leaf, fns = "kernel", conv
            elif isinstance(module, nn.LayerNorm) and pname == "weight":
                leaf, fns = "scale", ident
            else:
                leaf, fns = pname, ident
            out[f"{base}/{leaf}" if base else leaf] = (p, *fns)
    return out


def load_flax_params(model: nn.Module, params: Dict) -> None:
    """Fill ``model`` from a flax ``variables['params']`` tree (arrays or nested
    dicts of arrays, or an already flat '/'-keyed dict)."""
    flat = flatten_params(params)
    leaves = _leaf_map(model)
    missing = sorted(set(leaves) - set(flat))
    unused = sorted(set(flat) - set(leaves))
    if missing or unused:
        raise ValueError(f"flax tree does not match the model: missing {missing}, "
                         f"unused {unused}")
    with torch.no_grad():
        for key, (p, to_torch, _) in leaves.items():
            value = torch.from_numpy(np.array(to_torch(flat[key])))
            if value.shape != p.shape:
                raise ValueError(f"{key}: flax shape {tuple(value.shape)} -> torch "
                                 f"{tuple(p.shape)} expected")
            p.copy_(value.to(p.dtype))


def export_flax_params(model: nn.Module) -> Dict:
    """The model's parameters as a nested flax-layout tree of numpy arrays."""
    flat = {key: np.ascontiguousarray(to_flax(p.detach().float().cpu().numpy()))
            for key, (p, _, to_flax) in _leaf_map(model).items()}
    return unflatten_params(flat)


def load_npz(model: nn.Module, path: str) -> None:
    """Load an ``.npz`` of the flattened flax param tree ('/'-joined keys)."""
    with np.load(path) as data:
        load_flax_params(model, {k: data[k] for k in data.files})
