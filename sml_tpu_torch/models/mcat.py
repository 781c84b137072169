"""MCAT, the genomic-guided co-attention survival model (counterpart of
``sml_tpu/models/mcat.py:MCATSurv``), in its "small" sizes.

The bag goes through ``wsi_net`` (input_path_dim -> 256, ReLU); the gene
vector splits into its signature groups (100, 100, 100, 131), each through
its own two-block SNN stack; the four omic embeddings query the bag's tokens
through a one-head ``RawMultiheadAttention`` (4 queries x N keys, plain
einsums: no kernel).  Each of the two token sets (the co-attended path tokens
and the omic tokens) goes through a two-layer post-norm transformer (8 heads,
FFN 512), gated attention pooling and ``{prefix}_rho``; the two vectors are
fused by concat (``mm0``, ``mm1``) or ``BilinearFusion`` (``mm``), and the
classifier gives logits, hazards = sigmoid(logits) and S = cumprod(1 - h).
Submodules carry the flax tree's names.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from sml_tpu_torch.ops.attention import RawMultiheadAttention
from sml_tpu_torch.ops.common import Dense, Dropout, DropoutRNG
from sml_tpu_torch.ops.fusion import BilinearFusion
from sml_tpu_torch.ops.pooling import AttnNetGated
from sml_tpu_torch.ops.snn import SNNStack
from sml_tpu_torch.ops.transformer import TransformerEncoder

D = 256                 # the "small" sizes: WSI (1024, 256, 256), omic (256, 256)
OMIC_HIDDEN = (D, D)
OMIC_SIZES = (100, 100, 100, 131)


def signature_tokens(model: nn.Module, x_omic: torch.Tensor,
                     gen: Optional[torch.Generator]) -> torch.Tensor:
    """(B, G, D): each signature group of ``x_omic`` through the model's own
    SNN stack ``sig_net{g}`` (MCAT's and CMTA's genomic tokens)."""
    tokens, offset = [], 0
    for idx, size in enumerate(OMIC_SIZES):
        tokens.append(getattr(model, f"sig_net{idx}")(x_omic[:, offset:offset + size], gen))
        offset += size
    return torch.stack(tokens, dim=1)


def survival_head(logits: torch.Tensor) -> Dict[str, torch.Tensor]:
    """logits, hazards = sigmoid(logits) and S = cumprod(1 - hazards)."""
    hazards = torch.sigmoid(logits)
    return {"logits": logits, "hazards": hazards, "S": torch.cumprod(1.0 - hazards, dim=1)}


class MCATSurv(nn.Module):
    def __init__(self, label_dim: int, input_path_dim: int, fusion: str,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if fusion not in ("concat", "bilinear"):
            raise NotImplementedError(f"fusion {fusion!r}")
        self.fusion = fusion
        self.wsi_net = Dense(input_path_dim, D, dtype=dtype)
        self.wsi_drop = Dropout(0.25)
        for idx, size in enumerate(OMIC_SIZES):
            self.add_module(f"sig_net{idx}", SNNStack(size, OMIC_HIDDEN, dtype))
        self.coattn = RawMultiheadAttention(D, 1, dtype=dtype)
        for prefix in ("path", "omic"):
            self.add_module(f"{prefix}_transformer", TransformerEncoder(2, D, 8, dtype))
            self.add_module(f"{prefix}_attention_head", AttnNetGated(D, dtype))
            self.add_module(f"{prefix}_rho", Dense(D, D, dtype=dtype))
        self.branch_drop = Dropout(0.25)
        if fusion == "concat":
            self.mm0 = Dense(2 * D, D, dtype=dtype)
            self.mm1 = Dense(D, D, dtype=dtype)
        else:
            # the JAX module's batched (B, d) call of the reference's block
            self.mm = BilinearFusion(dim1=D, dim2=D, scale_dim1=8, scale_dim2=8, mmhid=D,
                                     dtype=dtype)
        self.classifier = Dense(D, label_dim, dtype=dtype)

    def _pooled(self, prefix: str, tokens: torch.Tensor,
                gen: Optional[torch.Generator]) -> torch.Tensor:
        """{prefix}_transformer -> gated attention pooling -> {prefix}_rho."""
        trans = getattr(self, f"{prefix}_transformer")(tokens, gen)
        a, h = getattr(self, f"{prefix}_attention_head")(trans, gen)
        a = torch.softmax(a.transpose(1, 2), dim=-1)                 # (B, 1, G)
        dt = torch.promote_types(a.dtype, h.dtype)
        pooled = torch.einsum("bkg,bgd->bkd", a.to(dt), h.to(dt))[:, 0]
        return self.branch_drop(torch.relu(getattr(self, f"{prefix}_rho")(pooled)), gen)

    def forward(self, x_path: torch.Tensor, x_omic: torch.Tensor,
                rng: Optional[DropoutRNG] = None) -> Dict[str, torch.Tensor]:
        """x_path (B, N, input_path_dim), x_omic (B, sum(OMIC_SIZES)); ``rng``
        feeds dropout in training mode."""
        gen = None if rng is None else rng.device
        h_path_bag = self.wsi_drop(torch.relu(self.wsi_net(x_path)), gen)
        h_omic_bag = signature_tokens(self, x_omic, gen)             # (B, G, D)
        h_path_coattn, a_coattn = self.coattn(h_omic_bag, h_path_bag, h_path_bag,
                                              generator=gen)
        h_path = self._pooled("path", h_path_coattn, gen)
        h_omic_pooled = self._pooled("omic", h_omic_bag, gen)
        if self.fusion == "concat":
            h = torch.cat([h_path, h_omic_pooled.to(h_path.dtype)], dim=1)
            h = torch.relu(self.mm1(torch.relu(self.mm0(h))))
        else:
            h = self.mm(h_path, h_omic_pooled, rng)
        return {**survival_head(self.classifier(h)), "coattn": a_coattn}
