"""Reference ``state_dict`` -> the port's modules (counterpart of
``sml_tpu/utils/torch_compat.py``, whose numpy converter the port keeps as its
own copy).

``convert_reference_state_dict`` maps a reference model's ``state_dict``
(helenypzhang/Subspace-Multimodal-Learning ``.pth`` files; reference
``models/model.py:142-187, 353-544, 559-705, 714-853``,
``models/DeformCrossTransMIL.py:79-160``, ``models/mil.py:34-259``) onto the
flax variables tree the port's weight bridge reads, and
``load_reference_state_dict`` loads it straight into a port model.

Layout conventions translated:
* ``nn.Linear`` weight (out, in)            -> Dense kernel (in, out)
* ``nn.Conv2d`` weight (out, in/g, kh, kw)  -> flax Conv kernel (kh, kw, in/g, out)
* ``nn.Conv1d`` weight (out, in/g, k)       -> flax Conv kernel (k, in/g, out)
* ``nn.Bilinear`` weight (out, in1, in2)    -> kept as-is
* packed MHA ``in_proj_weight`` (3E, E)     -> split q/k/v Dense kernels
* Nystrom ``res_conv`` (h, 1, K, 1)         -> merged-channel kernel (K, h)
* ``nn.BatchNorm1d``                        -> params scale/bias + batch_stats mean/var

Every converter consumes keys from a tracking dict; ``convert_reference_state_dict``
raises if any unexpected reference key is left over, so drift between the two
implementations is caught loudly.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from sml_tpu_torch.bridge import load_flax_params
from sml_tpu_torch.config import Config

N_SIG_GROUPS = 4    # MCAT's and CMTA's genomic signature groups (sig_networks.0-3)


class StateDict:
    """A torch state_dict (as numpy) with consumption tracking."""

    def __init__(self, sd: Dict[str, "np.ndarray"]):
        self.sd = {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                   else np.asarray(v) for k, v in sd.items()}
        self.used = set()

    def take(self, key: str) -> np.ndarray:
        self.used.add(key)
        return self.sd[key]

    def __contains__(self, key: str) -> bool:
        return key in self.sd

    def leftover(self, ignore_suffixes: Tuple[str, ...] = ()) -> list:
        rest = []
        for k in self.sd:
            if k in self.used:
                continue
            if any(k.endswith(suf) or suf in k for suf in ignore_suffixes):
                continue
            rest.append(k)
        return sorted(rest)


def _lin(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.swapaxes(w, 0, 1))


def _conv2d(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def _conv1d(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(w, (2, 1, 0)))


def dense(sd: StateDict, p: str, bias: bool = True) -> dict:
    out = {"kernel": _lin(sd.take(p + ".weight"))}
    if bias:
        out["bias"] = sd.take(p + ".bias")
    return out


def conv2d(sd: StateDict, p: str, bias: bool = True) -> dict:
    out = {"kernel": _conv2d(sd.take(p + ".weight"))}
    if bias:
        out["bias"] = sd.take(p + ".bias")
    return out


def conv1d(sd: StateDict, p: str, bias: bool = True) -> dict:
    out = {"kernel": _conv1d(sd.take(p + ".weight"))}
    if bias:
        out["bias"] = sd.take(p + ".bias")
    return out


def layernorm(sd: StateDict, p: str) -> dict:
    return {"scale": sd.take(p + ".weight"), "bias": sd.take(p + ".bias")}


def packed_mha(sd: StateDict, p: str) -> dict:
    """Vendored torch MultiheadAttention (packed qkv) -> RawMultiheadAttention."""
    w = sd.take(p + ".in_proj_weight")
    b = sd.take(p + ".in_proj_bias")
    e = w.shape[1]
    return {
        "q_proj": {"kernel": _lin(w[:e]), "bias": b[:e]},
        "k_proj": {"kernel": _lin(w[e:2 * e]), "bias": b[e:2 * e]},
        "v_proj": {"kernel": _lin(w[2 * e:]), "bias": b[2 * e:]},
        "out_proj": dense(sd, p + ".out_proj"),
    }


def maxnet(sd: StateDict, p: str, with_classifier: bool = True) -> dict:
    """MaxNet (reference ``models/model.py:142-187``)."""
    out = {f"encoder{i + 1}": dense(sd, f"{p}encoder.{i}.0") for i in range(4)}
    if with_classifier:
        out["classifier"] = dense(sd, p + "classifier.0")
    # constant non-trainable buffers with no flax counterpart
    for buf in ("output_range", "output_shift"):
        if p + buf in sd:
            sd.take(p + buf)
    return out


def abmil(sd: StateDict, p: str) -> dict:
    """ABMIL (reference ``models/mil.py:34-99``)."""
    return {
        "attention_0": dense(sd, p + "attention.0"),
        "attention_1": dense(sd, p + "attention.2"),
        "classifier": dense(sd, p + "classifier.0"),
        "multimodal_projection": dense(sd, p + "multimodal_projection"),
    }


def nystrom_attention(sd: StateDict, p: str) -> dict:
    """NystromAttention (reference ``models/NystromAttention.py:39-157``)."""
    res = sd.take(p + "res_conv.weight")          # (h, 1, K, 1)
    return {
        "to_qkv": {"kernel": _lin(sd.take(p + "to_qkv.weight"))},
        "to_out": dense(sd, p + "to_out.0"),
        "res_conv_kernel": np.ascontiguousarray(res[:, 0, :, 0].T),  # (K, h)
    }


def translayer(sd: StateDict, p: str) -> dict:
    return {"norm": layernorm(sd, p + "norm"),
            "attn": nystrom_attention(sd, p + "attn.")}


def ppeg(sd: StateDict, p: str) -> dict:
    return {"proj": conv2d(sd, p + "proj"),
            "proj1": conv2d(sd, p + "proj1"),
            "proj2": conv2d(sd, p + "proj2")}


def transmil(sd: StateDict, p: str = "") -> dict:
    """TransMIL (reference ``models/mil.py:209-259``)."""
    return {
        "cls_token": sd.take(p + "cls_token"),
        "fc1": dense(sd, p + "_fc1.0"),
        "layer1": translayer(sd, p + "layer1."),
        "layer2": translayer(sd, p + "layer2."),
        "pos_layer": ppeg(sd, p + "pos_layer."),
        "norm": layernorm(sd, p + "norm"),
        "fc2": dense(sd, p + "_fc2"),
        "multimodal_projection": dense(sd, p + "multimodal_projection"),
    }


def bilinear_fusion(sd: StateDict, p: str, use_bilinear: bool = True
                    ) -> Tuple[dict, dict]:
    """BilinearFusion (reference ``models/fusion.py:6-63``) -> (params, batch_stats)."""
    params = {}
    for i in (1, 2):
        params[f"linear_h{i}"] = dense(sd, f"{p}linear_h{i}.0")
        if use_bilinear:
            params[f"linear_z{i}"] = {"weight": sd.take(f"{p}linear_z{i}.weight"),
                                      "bias": sd.take(f"{p}linear_z{i}.bias")}
        else:
            params[f"linear_z{i}"] = dense(sd, f"{p}linear_z{i}.0")
        params[f"linear_o{i}"] = dense(sd, f"{p}linear_o{i}.0")
    stats = {}
    for i in (1, 2):
        params[f"encoder{i}"] = dense(sd, f"{p}encoder{i}.0")
        params[f"bn{i}"] = {"scale": sd.take(f"{p}encoder{i}.1.weight"),
                            "bias": sd.take(f"{p}encoder{i}.1.bias")}
        stats[f"bn{i}"] = {"mean": sd.take(f"{p}encoder{i}.1.running_mean"),
                           "var": sd.take(f"{p}encoder{i}.1.running_var")}
    return params, stats


def cpb2d(sd: StateDict, p: str) -> dict:
    """CPB MLP (reference ``models/DeformableAttention2D.py:120-157``)."""
    return {
        "w0": _lin(sd.take(p + "mlp.0.0.weight")), "b0": sd.take(p + "mlp.0.0.bias"),
        "w1": _lin(sd.take(p + "mlp.1.0.weight")), "b1": sd.take(p + "mlp.1.0.bias"),
        "w2": _lin(sd.take(p + "mlp.2.weight")), "b2": sd.take(p + "mlp.2.bias"),
    }


def deform_attn2d(sd: StateDict, p: str) -> dict:
    """DeformCrossAttention2D (reference ``models/DeformableAttention2D.py:161-325``)."""
    return {
        "to_q": conv2d(sd, p + "to_q", bias=False),
        "to_k": conv2d(sd, p + "to_k", bias=False),
        "to_v": conv2d(sd, p + "to_v", bias=False),
        "to_out": conv2d(sd, p + "to_out"),
        "offset_conv": conv2d(sd, p + "to_offsets.0"),
        "offset_proj": conv2d(sd, p + "to_offsets.2", bias=False),
        "rel_pos_bias": cpb2d(sd, p + "rel_pos_bias."),
    }


def deform_attn1d(sd: StateDict, p: str) -> dict:
    """DeformCrossAttention1D (reference ``models/DeformableAttention1D.py:106-240``)."""
    return {
        "to_q": conv1d(sd, p + "to_q", bias=False),
        "to_k": conv1d(sd, p + "to_k", bias=False),
        "to_v": conv1d(sd, p + "to_v", bias=False),
        "to_out": conv1d(sd, p + "to_out"),
        "offset_conv": conv1d(sd, p + "to_offsets.0"),
        "offset_proj": conv1d(sd, p + "to_offsets.2", bias=False),
        "rel_pos_bias": cpb2d(sd, p + "rel_pos_bias."),  # same MLP naming, 1-D input
    }


def deform_mil(sd: StateDict, p: str, attn_dim: int = 2) -> dict:
    """DeformCrossTransMIL (reference ``models/DeformCrossTransMIL.py:79-160``).

    The reference instantiates BOTH attn1d and attn2d and uses one; the unused
    branch's keys are consumed (so leftover checking passes) but not emitted.
    """
    out = {
        "fc1": dense(sd, p + "_fc1.0"),
        "fusion_layer": {"fusion_layer": dense(sd, p + "fusion_layer.fusion_layer")},
        "layer3": {"norm": layernorm(sd, p + "layer3.norm")},
        "norm": layernorm(sd, p + "norm"),
        "fc2": dense(sd, p + "_fc2"),
        "multimodal_projection": dense(sd, p + "multimodal_projection"),
    }
    used = deform_attn2d(sd, p + "layer3.attn2d.")
    unused = deform_attn1d(sd, p + "layer3.attn1d.")
    if attn_dim == 1:
        used, unused = unused, used
        out["cls_token"] = sd.take(p + "cls_token")
        out["layer3"]["attn1d"] = used
    else:
        sd.take(p + "cls_token")  # declared but unused by the 2-D path
        out["layer3"]["attn2d"] = used
        out["pooler"] = {"dense": dense(sd, p + "pooler.dense")}
    del unused
    if attn_dim == 1 and p + "pooler.dense.weight" in sd:
        dense(sd, p + "pooler.dense")  # consume the unused pooler
    return out


def attn_net_gated(sd: StateDict, p: str) -> dict:
    """Attn_Net_Gated (reference ``models/mcat_utils.py:115-145``)."""
    return {
        "attention_a": dense(sd, p + "attention_a.0"),
        "attention_b": dense(sd, p + "attention_b.0"),
        "attention_c": dense(sd, p + "attention_c"),
    }


def snn_stack(sd: StateDict, p: str, depth: int) -> dict:
    """SNN_Block stack (reference ``models/mcat_utils.py:81-95``)."""
    return {f"SNNBlock_{j}": {"Dense_0": dense(sd, f"{p}{j}.0")}
            for j in range(depth)}


def torch_encoder_layer(sd: StateDict, p: str) -> dict:
    """torch ``nn.TransformerEncoderLayer`` -> sml_tpu TransformerEncoderLayer."""
    return {
        "self_attn": packed_mha(sd, p + "self_attn"),
        "linear1": dense(sd, p + "linear1"),
        "linear2": dense(sd, p + "linear2"),
        "norm1": layernorm(sd, p + "norm1"),
        "norm2": layernorm(sd, p + "norm2"),
    }


def transformer_p(sd: StateDict, p: str) -> dict:
    """Transformer_P (reference ``models/cmta_utils.py:894-924``)."""
    return {
        "cls_token": sd.take(p + "cls_token"),
        "layer1": translayer(sd, p + "layer1."),
        "layer2": translayer(sd, p + "layer2."),
        "pos_layer": ppeg(sd, p + "pos_layer."),
        "norm": layernorm(sd, p + "norm"),
    }


def transformer_g(sd: StateDict, p: str) -> dict:
    """Transformer_G (reference ``models/cmta_utils.py:927-948``)."""
    return {
        "cls_token": sd.take(p + "cls_token"),
        "layer1": translayer(sd, p + "layer1."),
        "layer2": translayer(sd, p + "layer2."),
        "norm": layernorm(sd, p + "norm"),
    }


def convert_reference_state_dict(mode: str, state_dict, *, attn_dim: int = 2,
                                 fusion_type: str = "concat") -> dict:
    """Convert a reference model's state_dict into flax ``variables``.

    ``mode`` is the reference's mode flag plus ``"transmil"`` for the class-level
    TransMIL model.  Raises ValueError on leftover (unmapped) reference keys.
    """
    sd = StateDict(state_dict)
    params: dict = {}
    stats: dict = {}

    if mode == "omic":
        params = maxnet(sd, "")
    elif mode == "path":
        params = abmil(sd, "")
    elif mode == "transmil":
        params = transmil(sd, "")
    elif mode in ("pathomic", "pathomic_original"):
        if mode == "pathomic":
            params["path_net"] = abmil(sd, "path_net.")
        else:
            params["path_net"] = dense(sd, "path_net.0")
            params["path_classifier"] = dense(sd, "path_classifier.0")
        params["omic_net"] = maxnet(sd, "omic_net.")
        if fusion_type == "pofusion":
            params["fusion"], stats["fusion"] = bilinear_fusion(sd, "fusion.")
        params["classifier"] = dense(sd, "classifier.0")
    elif mode == "deformpathomic":
        for branch in ("tumor", "immune"):
            params[f"omic_net_{branch}"] = maxnet(sd, f"omic_net_{branch}.")
            params[f"pathomic_net_{branch}"] = deform_mil(
                sd, f"pathomic_net_{branch}.", attn_dim=attn_dim)
        params["classifier"] = dense(sd, "classifier")
        params["classifier_tumor"] = dense(sd, "classifier_tumor.0")
        params["classifier_immune"] = dense(sd, "classifier_immune.0")
        if fusion_type == "pofusion" and "fusion.linear_h1.0.weight" in sd:
            params["fusion"], stats["fusion"] = bilinear_fusion(sd, "fusion.")
    elif mode == "mcat":
        params["wsi_net"] = dense(sd, "wsi_net.0")
        for i in range(N_SIG_GROUPS):
            params[f"sig_net{i}"] = snn_stack(sd, f"sig_networks.{i}.", depth=2)
        params["coattn"] = packed_mha(sd, "coattn")
        for prefix in ("path", "omic"):
            params[f"{prefix}_transformer"] = {
                f"layer{j}": torch_encoder_layer(sd, f"{prefix}_transformer.layers.{j}.")
                for j in range(2)}
            params[f"{prefix}_attention_head"] = attn_net_gated(
                sd, f"{prefix}_attention_head.")
            params[f"{prefix}_rho"] = dense(sd, f"{prefix}_rho.0")
        if "mm.0.weight" in sd:
            params["mm0"] = dense(sd, "mm.0")
            params["mm1"] = dense(sd, "mm.2")
        else:  # fusion='bilinear' variant (reference models/model.py:605-606)
            params["mm"], stats["mm"] = bilinear_fusion(sd, "mm.")
        params["classifier"] = dense(sd, "classifier")
    elif mode == "cmta":
        params["wsi_net"] = dense(sd, "wsi_net.0")
        for i in range(N_SIG_GROUPS):
            params[f"sig_net{i}"] = snn_stack(sd, f"sig_networks.{i}.", depth=2)
        params["pathomics_encoder"] = transformer_p(sd, "pathomics_encoder.")
        params["pathomics_decoder"] = transformer_p(sd, "pathomics_decoder.")
        params["genomics_encoder"] = transformer_g(sd, "genomics_encoder.")
        params["genomics_decoder"] = transformer_g(sd, "genomics_decoder.")
        params["P_in_G_Att"] = packed_mha(sd, "P_in_G_Att")
        params["G_in_P_Att"] = packed_mha(sd, "G_in_P_Att")
        if "mm.0.weight" in sd:
            params["mm0"] = dense(sd, "mm.0")
            params["mm1"] = dense(sd, "mm.2")
        else:  # bilinear fusion variant
            params["mm"], stats["mm"] = bilinear_fusion(sd, "mm.")
        params["classifier"] = dense(sd, "classifier")
    else:
        raise ValueError(f"unknown mode {mode!r}")

    rest = sd.leftover(ignore_suffixes=("output_range", "output_shift",
                                        "num_batches_tracked"))
    if rest:
        raise ValueError(f"unconverted reference keys for mode {mode!r}: {rest[:20]}")

    variables = {"params": params}
    if stats:
        variables["batch_stats"] = stats
    return variables


def reference_mode(config: Config) -> str:
    """The converter's mode of a config: its ``mode``, and ``"transmil"`` for
    ``--mode path --path_arch transmil``."""
    if config.mode == "path" and config.path_arch == "transmil":
        return "transmil"
    return config.mode


def load_reference_state_dict(model: nn.Module, state_dict, config: Config) -> None:
    """Fill ``model`` (the port's model of ``config``) from a reference
    ``state_dict`` of numpy arrays or torch tensors: converted, then loaded
    through the weight bridge.  A leftover reference key, or a leaf the model
    lacks or does not have, raises."""
    load_flax_params(model, convert_reference_state_dict(
        reference_mode(config), state_dict, attn_dim=config.attn_dim,
        fusion_type=config.fusion_type))
