"""CMTA, cross-modal translation and alignment (counterpart of
``sml_tpu/models/cmta.py``: ``TransformerP``, ``TransformerG``, ``CMTA``), at
its one geometry, 256 wide.

``TransformerP`` square-pads the bag by repeating its first tokens, prepends
a cls token (init normal(1e-6)) and runs TransLayer -> PPEG -> TransLayer ->
LayerNorm; ``TransformerG`` is a cls token and two TransLayers.  Each
TransLayer is a Nystrom attention of 8 heads of 32 with 128 landmarks, whose
two softmax chains take the f32 dh = 32 form of the attention kernels where
the shape gate admits them (a 2500-patch bag: 2501 tokens front-padded to
2560, at least 4 x 128); the genomic stream's 5 tokens never reach them, nor
does bf16 (32 x 2 bytes < 128).  The pathomics and genomics encoders give cls
tokens P and G and their tokens; ``P_in_G_Att`` (path tokens over the
genomic ones) and ``G_in_P_Att`` translate each stream into the other, the
decoders give P_hat and G_hat, and the averaged cls tokens are fused by concat
(``mm0``, ``mm1``) or ``BilinearFusion`` (``mm``) into logits, hazards and S.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from sml_tpu_torch.models.mcat import OMIC_SIZES, signature_tokens, survival_head
from sml_tpu_torch.models.mil import TransLayer
from sml_tpu_torch.ops.attention import RawMultiheadAttention
from sml_tpu_torch.ops.common import Dense, Dropout, DropoutRNG
from sml_tpu_torch.ops.conv import PPEG
from sml_tpu_torch.ops.fusion import BilinearFusion
from sml_tpu_torch.ops.snn import SNNStack

D = 256


class _ClsEncoder(nn.Module):
    """The cls token (flax's normal(1e-6)), the final LayerNorm and the
    split of its output into the cls token and the other tokens."""

    def __init__(self):
        super().__init__()
        self.cls_token = nn.Parameter(torch.empty(1, 1, D))
        self.norm = nn.LayerNorm(D, eps=1e-5)

    def init_raw_params(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.cls_token.normal_(0.0, 1e-6, generator=generator)

    def _with_cls(self, h: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.cls_token.expand(h.shape[0], 1, -1).to(h.dtype), h], dim=1)

    def _split(self, h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        h = self.norm(h.float())
        return h[:, 0], h[:, 1:]


class TransformerP(_ClsEncoder):
    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.layer1 = TransLayer(D, dtype=dtype)
        self.pos_layer = PPEG(D, dtype=dtype)
        self.layer2 = TransLayer(D, dtype=dtype)

    def forward(self, features: torch.Tensor, rng: Optional[DropoutRNG] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        n = features.shape[1]
        side = int(math.ceil(math.sqrt(n)))
        add_length = side * side - n
        h = features
        if add_length:
            h = torch.cat([h, h[:, :add_length]], dim=1)
        h = self.layer1(self._with_cls(h), rng=rng)
        h = self.pos_layer(h, side, side)
        return self._split(self.layer2(h, rng=rng))


class TransformerG(_ClsEncoder):
    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.layer1 = TransLayer(D, dtype=dtype)
        self.layer2 = TransLayer(D, dtype=dtype)

    def forward(self, features: torch.Tensor, rng: Optional[DropoutRNG] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        h = self.layer1(self._with_cls(features), rng=rng)
        return self._split(self.layer2(h, rng=rng))


class CMTA(nn.Module):
    def __init__(self, label_dim: int, input_path_dim: int, fusion: str,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if fusion not in ("concat", "bilinear"):
            raise NotImplementedError(f"fusion {fusion!r}")
        self.fusion = fusion
        self.wsi_net = Dense(input_path_dim, D, dtype=dtype)
        self.wsi_drop = Dropout(0.25)
        for idx, size in enumerate(OMIC_SIZES):
            self.add_module(f"sig_net{idx}", SNNStack(size, (D, D), dtype))
        self.pathomics_encoder = TransformerP(dtype)
        self.genomics_encoder = TransformerG(dtype)
        self.P_in_G_Att = RawMultiheadAttention(D, 1, dtype=dtype)
        self.G_in_P_Att = RawMultiheadAttention(D, 1, dtype=dtype)
        self.pathomics_decoder = TransformerP(dtype)
        self.genomics_decoder = TransformerG(dtype)
        if fusion == "concat":
            self.mm0 = Dense(2 * D, D, dtype=dtype)
            self.mm1 = Dense(D, D, dtype=dtype)
        else:
            self.mm = BilinearFusion(dim1=D, dim2=D, scale_dim1=8, scale_dim2=8, mmhid=D,
                                     dtype=dtype)
        self.classifier = Dense(D, label_dim, dtype=dtype)

    def forward(self, x_path: torch.Tensor, x_omic: torch.Tensor,
                rng: Optional[DropoutRNG] = None) -> Dict[str, torch.Tensor]:
        """x_path (B, N, input_path_dim), x_omic (B, sum(OMIC_SIZES)); ``rng``
        feeds dropout in training mode."""
        gen = None if rng is None else rng.device
        h_path = self.wsi_drop(torch.relu(self.wsi_net(x_path)), gen)
        genomics = signature_tokens(self, x_omic, gen)               # (B, G, D)

        p_enc_cls, p_tok = self.pathomics_encoder(h_path, rng)
        g_enc_cls, g_tok = self.genomics_encoder(genomics, rng)
        p_in_g, _ = self.P_in_G_Att(p_tok, g_tok, g_tok, generator=gen)
        g_in_p, _ = self.G_in_P_Att(g_tok, p_tok, p_tok, generator=gen)
        p_dec_cls, _ = self.pathomics_decoder(p_in_g, rng)
        g_dec_cls, _ = self.genomics_decoder(g_in_p, rng)

        p_avg = (p_enc_cls + p_dec_cls) / 2.0
        g_avg = (g_enc_cls + g_dec_cls) / 2.0
        if self.fusion == "concat":
            h = torch.relu(self.mm1(torch.relu(self.mm0(torch.cat([p_avg, g_avg], dim=1)))))
        else:
            h = self.mm(p_avg, g_avg, rng)
        return {**survival_head(self.classifier(h)), "P": p_enc_cls, "P_hat": p_dec_cls,
                "G": g_enc_cls, "G_hat": g_dec_cls}
