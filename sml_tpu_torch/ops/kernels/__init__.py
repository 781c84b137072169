"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version:
the CPB bias and the deformable attention (ported Pallas kernels) and the JPEG
decoder's pixel stage (no Pallas counterpart: the JAX package decodes with PIL)."""

from sml_tpu_torch.ops.kernels.cpb_bias import (cpb_bias, cpb_bias_bwd, cpb_bias_bwd_plain,
                                                cpb_bias_plain, cpb_bias_trainable)
from sml_tpu_torch.ops.kernels.deform_attn import (deform_attention_bwd,
                                                   deform_attention_bwd_plain,
                                                   deform_attention_fwd,
                                                   deform_attention_fwd_plain,
                                                   deform_attention_trainable)
from sml_tpu_torch.ops.kernels.jpeg import jpeg_pixels, jpeg_pixels_plain
from sml_tpu_torch.ops.kernels.philox import philox_keep_mask

KERNELS = (cpb_bias, cpb_bias_bwd, deform_attention_fwd, deform_attention_bwd, jpeg_pixels)
# the per-form counts of the wrappers: (wrapper, attribute, key)
_FORMS = ((cpb_bias, "f32_launches", "cpb_bias_f32"),
          (cpb_bias_bwd, "f32_launches", "cpb_bias_bwd_f32"),
          (deform_attention_fwd, "dropout_launches", "deform_attention_fwd_dropout"),
          (deform_attention_fwd, "nobias_launches", "deform_attention_fwd_nobias"),
          (deform_attention_fwd, "span_launches", "deform_attention_fwd_span"),
          (deform_attention_fwd, "f32bias_launches", "deform_attention_fwd_f32bias"),
          (deform_attention_fwd, "dh32_launches", "deform_attention_fwd_dh32"),
          (deform_attention_fwd, "f32_launches", "deform_attention_fwd_f32"),
          (deform_attention_bwd, "nobias_launches", "deform_attention_bwd_nobias"),
          (deform_attention_bwd, "span_launches", "deform_attention_bwd_span"),
          (deform_attention_bwd, "f32bias_launches", "deform_attention_bwd_f32bias"),
          (deform_attention_bwd, "dh32_launches", "deform_attention_bwd_dh32"),
          (deform_attention_bwd, "f32_launches", "deform_attention_bwd_f32"))


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
    for fn, attr, _ in _FORMS:
        setattr(fn, attr, 0)


def launch_counts() -> dict:
    """{wrapper name: launches}, the CPB wrappers' f32 launches (the default
    compute dtype's), and the attention wrappers' launches by form: with
    dropout, without a bias, with a span, with an f32 bias beside bf16 q, k,
    v, at head dim 32, in f32 at head dim 64 (the default compute dtype's
    form)."""
    counts = {fn.__name__: fn.launches for fn in KERNELS}
    counts.update({key: getattr(fn, attr) for fn, attr, key in _FORMS})
    return counts


__all__ = ["cpb_bias", "cpb_bias_plain", "cpb_bias_bwd", "cpb_bias_bwd_plain",
           "cpb_bias_trainable", "deform_attention_fwd", "deform_attention_fwd_plain",
           "deform_attention_bwd", "deform_attention_bwd_plain",
           "deform_attention_trainable", "jpeg_pixels", "jpeg_pixels_plain",
           "philox_keep_mask", "KERNELS",
           "reset_launch_counts", "launch_counts"]
