"""Layers that compute in a given dtype, and the JAX package's initializers.

``Dense`` and ``Conv`` follow flax's ``dtype=`` rule: input, weight and bias are
cast to the compute dtype; on the card a bf16 product accumulates in f32 and
returns bf16.  Both keep torch's parameter layout (``weight`` (out, in) and
(out, in/groups, kh, kw)); ``sml_tpu_torch.bridge`` transposes the flax
kernels into it.  ``Conv`` takes and returns channels-last (N, H, W, C)
tensors, the JAX package's layout.

``DropoutRNG`` carries the two generators of training-mode dropout.

Initializers (``init_params``) draw from an explicit ``torch.Generator`` with
the JAX initializers' distributions: ``torch_kernel_init`` is
U(+-1/sqrt(fan_in)); ``max_kernel_init`` is a normal truncated at two standard
deviations with variance 1/fan_in (JAX's ``variance_scaling(1, fan_in,
"normal")``); biases are zero.
"""

from __future__ import annotations

import dataclasses
import math

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
        if isinstance(module, (Dense, Conv)):
            fan_in = module.weight[0].numel()
            init = max_kernel_init_ if module.kernel_init == "max" else torch_kernel_init_
            init(module.weight, fan_in, g)
            if module.bias is not None:
                nn.init.zeros_(module.bias)
        elif isinstance(module, nn.LayerNorm):
            nn.init.ones_(module.weight)
            nn.init.zeros_(module.bias)
        elif hasattr(module, "init_raw_params"):
            module.init_raw_params(g)
