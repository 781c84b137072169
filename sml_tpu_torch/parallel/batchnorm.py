"""Cross-rank batch normalization (counterpart of
``sml_tpu/parallel/batchnorm.py``).

``torch.nn.SyncBatchNorm`` refuses CPU tensors, so the port takes its own
moments over a process group: ``moments`` sums the count and the features
over the group, then the squared deviations from the global mean, each by a
differentiable all-reduce whose backward sums the gradient over the group too
(the two-pass variance of the port's ``BatchNorm``, ``ops/fusion.py``).  The
model's ``BatchNorm`` uses it when its data group holds more than one rank;
``SyncBatchNorm`` is the JAX module: flax momentum 0.9, epsilon 1e-5, and
running averages of the mean and the unbiased variance.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from sml_tpu_torch.parallel.collectives import all_reduce_sum


def moments(x: torch.Tensor, group=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(mean, biased variance, count) over the leading axis of (B, C) ``x`` on
    every rank of ``group`` (this rank's alone when ``group`` is None)."""
    if group is None:
        mean = x.mean(dim=0)
        return mean, ((x - mean) ** 2).mean(dim=0), x.new_tensor(float(x.shape[0]))
    n_s = all_reduce_sum(torch.cat([x.new_tensor([float(x.shape[0])]), x.sum(dim=0)]),
                         group)
    n, mean = n_s[0], n_s[1:] / n_s[0]
    var = all_reduce_sum(((x - mean) ** 2).sum(dim=0), group) / n
    return mean, var, n


class SyncBatchNorm(nn.Module):
    """BatchNorm over (B, C) features with moments over ``group`` (this rank's
    batch when None), in f32."""

    def __init__(self, features: int, momentum: float = 0.9, epsilon: float = 1e-5,
                 group=None):
        super().__init__()
        self.momentum, self.epsilon, self.group = momentum, epsilon, group
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, use_running_average: Optional[bool] = None
                ) -> torch.Tensor:
        x = x.float()
        if use_running_average if use_running_average is not None else not self.training:
            mean, var = self.mean, self.var
        else:
            mean, var, n = moments(x, self.group)
            with torch.no_grad():
                m = self.momentum
                self.mean.mul_(m).add_((1 - m) * mean)
                self.var.mul_(m).add_((1 - m) * var * n / (n - 1).clamp_min(1))
        return (x - mean) * torch.rsqrt(var + self.epsilon) * self.scale + self.bias
