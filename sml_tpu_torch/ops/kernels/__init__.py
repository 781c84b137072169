"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version."""

from sml_tpu_torch.ops.kernels.cpb_bias import (cpb_bias, cpb_bias_bwd, cpb_bias_bwd_plain,
                                                cpb_bias_plain, cpb_bias_trainable)
from sml_tpu_torch.ops.kernels.deform_attn import (deform_attention_bwd,
                                                   deform_attention_bwd_plain,
                                                   deform_attention_fwd,
                                                   deform_attention_fwd_plain,
                                                   deform_attention_trainable)
from sml_tpu_torch.ops.kernels.philox import philox_keep_mask

KERNELS = (cpb_bias, cpb_bias_bwd, deform_attention_fwd, deform_attention_bwd)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
    deform_attention_fwd.dropout_launches = 0


def launch_counts() -> dict:
    """{wrapper name: launches}, and the dropout launches of the attention forward."""
    counts = {fn.__name__: fn.launches for fn in KERNELS}
    counts["deform_attention_fwd_dropout"] = deform_attention_fwd.dropout_launches
    return counts


__all__ = ["cpb_bias", "cpb_bias_plain", "cpb_bias_bwd", "cpb_bias_bwd_plain",
           "cpb_bias_trainable", "deform_attention_fwd", "deform_attention_fwd_plain",
           "deform_attention_bwd", "deform_attention_bwd_plain",
           "deform_attention_trainable", "philox_keep_mask", "KERNELS",
           "reset_launch_counts", "launch_counts"]
