"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version."""

from sml_tpu_torch.ops.kernels.cpb_bias import cpb_bias, cpb_bias_plain
from sml_tpu_torch.ops.kernels.deform_attn import (deform_attention_fwd,
                                                   deform_attention_fwd_plain)

KERNELS = (cpb_bias, deform_attention_fwd)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


__all__ = ["cpb_bias", "cpb_bias_plain", "deform_attention_fwd",
           "deform_attention_fwd_plain", "KERNELS", "reset_launch_counts"]
