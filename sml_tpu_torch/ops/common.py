"""Layers that compute in a given dtype, and the JAX package's initializers.

``Dense``, ``Conv`` and ``Conv1`` follow flax's ``dtype=`` rule: input, weight
and bias are cast to the compute dtype; on the card a bf16 product
accumulates in f32 and returns bf16.  They keep torch's parameter layout
(``weight`` (out, in), (out, in/groups, kh, kw) and (out, in/groups, k));
``sml_tpu_torch.bridge`` transposes the flax kernels into it (``Bilinear``'s
(out, in1, in2) is flax's own).  ``Conv`` takes and returns channels-last (N, H, W, C) tensors and
``Conv1`` channels-last (N, L, C), the JAX package's layouts.

``DropoutRNG`` carries the two generators of training-mode dropout, and
``dropout`` is flax's inverted dropout drawn from one of them (``Dropout``,
the same as a module holding its rate).

Initializers (``init_params``) draw from an explicit ``torch.Generator`` with
the JAX initializers' distributions: ``torch_kernel_init`` is
U(+-1/sqrt(fan_in)); ``max_kernel_init`` is a normal truncated at two standard
deviations with variance 1/fan_in (JAX's ``variance_scaling(1, fan_in,
"normal")``); ``Bilinear`` takes U(+-1/sqrt(in1)) (``torch_bilinear_init``);
biases are zero.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

# JAX's truncated_normal(-2, 2) has std 0.8796...; variance_scaling divides it out
_TRUNC_STD = 0.87962566103423978


@dataclasses.dataclass
class DropoutRNG:
    """The explicit generators of training-mode dropout (the counterpart of
    flax's ``'dropout'`` rng stream): ``device`` draws AlphaDropout's noise on
    the model's device; ``host``, a CPU generator, draws the 64-bit Philox
    seeds of the attention kernels without waiting on the device."""
    device: torch.Generator
    host: torch.Generator

    @classmethod
    def from_seed(cls, seed: int, device) -> "DropoutRNG":
        device = torch.device(device)
        return cls(torch.Generator(device=device).manual_seed(seed),
                   torch.Generator().manual_seed(seed + 1))

    def philox_seed(self) -> int:
        return int(torch.randint(0, 2 ** 62, (1,), generator=self.host))

    def get_state(self) -> Dict[str, torch.Tensor]:
        """Both generators' states (CPU byte tensors)."""
        return {"device": self.device.get_state(), "host": self.host.get_state()}

    def set_state(self, state: Dict[str, torch.Tensor]) -> None:
        self.device.set_state(state["device"])
        self.host.set_state(state["host"])


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout (flax ``nn.Dropout``): each element kept with
    probability 1 - rate and scaled by 1 / (1 - rate); identity at eval or
    when rate == 0.  Training needs an explicit generator."""
    if not training or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("training-mode dropout needs a DropoutRNG generator")
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class Dropout(nn.Module):
    """:func:`dropout` at ``rate``, in the module's training mode."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return dropout(x, self.rate, self.training, generator)


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


class Dense(nn.Linear):
    """``nn.Linear`` computing in ``dtype``; ``kernel_init`` is "torch" or "max"."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32, kernel_init: str = "torch"):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype
        self.kernel_init = kernel_init

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cdt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(cdt)
        return F.linear(x.to(cdt), self.weight.to(cdt), b)


class Conv(nn.Conv2d):
    """``nn.Conv2d`` on channels-last (N, H, W, C) tensors, computing in ``dtype``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 1,
                 stride: int = 1, padding: int = 0, groups: int = 1,
                 bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=padding, groups=groups, bias=bias)
        self.compute_dtype = dtype
        self.kernel_init = "torch"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cdt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(cdt)
        y = F.conv2d(x.to(cdt).permute(0, 3, 1, 2), self.weight.to(cdt), b,
                     self.stride, self.padding, 1, self.groups)
        return y.permute(0, 2, 3, 1).contiguous()


class Conv1(nn.Conv1d):
    """``nn.Conv1d`` on channels-last (N, L, C) tensors, computing in ``dtype``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 1,
                 stride: int = 1, padding: int = 0, groups: int = 1,
                 bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=padding, groups=groups, bias=bias)
        self.compute_dtype = dtype
        self.kernel_init = "torch"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cdt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(cdt)
        y = F.conv1d(x.to(cdt).transpose(1, 2), self.weight.to(cdt), b, self.stride,
                     self.padding, 1, self.groups)
        return y.transpose(1, 2).contiguous()


class Bilinear(nn.Bilinear):
    """torch ``nn.Bilinear``, out_o = x1^T W_o x2 + b_o (the JAX package's
    ``ops/fusion.py:Bilinear``, whose ``weight`` has torch's (out, in1, in2)
    layout).  That module takes no compute dtype: its einsum promotes bf16
    inputs to the f32 parameters, and so does this one.  It takes the JAX
    einsum (two batched products) rather than ``F.bilinear``, which on CUDA
    runs a matrix product per output feature in a train step."""

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        w = self.weight
        return torch.einsum("bi,oij,bj->bo", x1.to(w.dtype), w, x2.to(w.dtype)) + self.bias


def torch_kernel_init_(w: torch.Tensor, fan_in: int,
                       generator: torch.Generator) -> None:
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        w.uniform_(-bound, bound, generator=generator)


def max_kernel_init_(w: torch.Tensor, fan_in: int,
                     generator: torch.Generator) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)


def init_params(model: nn.Module, seed: int) -> None:
    """Seeded init of every parameter, module by module in registration order."""
    g = torch.Generator().manual_seed(seed)
    for module in model.modules():
        if isinstance(module, (Dense, Conv, Conv1)):
            fan_in = module.weight[0].numel()
            init = max_kernel_init_ if module.kernel_init == "max" else torch_kernel_init_
            init(module.weight, fan_in, g)
            if module.bias is not None:
                nn.init.zeros_(module.bias)
        elif isinstance(module, Bilinear):
            torch_kernel_init_(module.weight, module.weight.shape[1], g)
            nn.init.zeros_(module.bias)
        elif isinstance(module, nn.LayerNorm):
            nn.init.ones_(module.weight)
            nn.init.zeros_(module.bias)
        elif hasattr(module, "init_raw_params"):
            module.init_raw_params(g)
