"""The port's CMTA (``mode: cmta``) against the JAX package on the same weights,
f32, at the repo's parity tolerance (TOL, 1e-4): the weight bridge in both
``coattn_fusion``s, the forward and eval step on small bags (the XLA route of
the Nystrom chains on both sides), one train step's loss and every gradient
in survival and diag2021, and the two CLIs on the CPU.  Dropout is held at 0
on both sides for the train step (see ``test_torch_mcat.py``).  The fused
chains, at the dh = 32 form of the attention kernels: ``test_torch_cmta_chains.py``.
"""

import pytest

from test_torch_mcat import (FUSIONS, SMALL, check_bridge, check_forward_and_eval,
                             check_inference_cli, check_train_cli, check_train_step,
                             no_jax_dropout)

CMTA_SMALL = dict(SMALL, mode="cmta")
CMTA_OUT = ("logits", "hazards", "S", "P", "P_hat", "G", "G_hat")

__all__ = ["no_jax_dropout"]      # the fixture, used by name


@pytest.mark.parametrize("fusion", FUSIONS)
def test_bridge_round_trips_the_cmta_tree(fusion):
    flat = check_bridge(dict(CMTA_SMALL, coattn_fusion=fusion))
    assert {"pathomics_encoder/cls_token", "genomics_decoder/cls_token",
            "pathomics_decoder/layer2/attn/res_conv_kernel",
            "pathomics_encoder/pos_layer/proj1/kernel", "P_in_G_Att/k_proj/kernel",
            "genomics_encoder/norm/scale"} <= set(flat)
    assert ("mm/bn1/scale" in flat) == (fusion == "bilinear")


@pytest.mark.parametrize("fusion", FUSIONS)
def test_forward_and_eval_step_match_jax(fusion):
    check_forward_and_eval(dict(CMTA_SMALL, coattn_fusion=fusion, task_type="survival"),
                           CMTA_OUT)


@pytest.mark.parametrize("task_type,fusion,survival_loss", [
    ("survival", "bilinear", "nll_surv_ol"), ("diag2021", "concat", "nll_surv")])
def test_train_step_matches_jax(task_type, fusion, survival_loss, no_jax_dropout):
    check_train_step(dict(CMTA_SMALL, coattn_fusion=fusion, task_type=task_type,
                          survival_loss=survival_loss))


def test_inference_cli_matches_jax_evaluate(tmp_path, capsys):
    check_inference_cli(dict(CMTA_SMALL, task_type="survival"), tmp_path, capsys)


def test_train_cli_two_epochs(tmp_path, capsys):
    check_train_cli(dict(CMTA_SMALL, task_type="survival", synthetic_size=12), tmp_path,
                    capsys, ("loss", "loss3", "alignment_loss"))
