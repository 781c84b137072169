"""The port's loss zoo against the JAX package, f32 (TOL, 1e-4), on
numpy-seeded inputs: every ``survival_loss`` name through ``compute_mode_loss``
(the total, its terms and the gradient with respect to every model output,
which holds the detached cls tokens of CMTA's alignment where JAX stops the
gradient), with and without a ``sample_mask``, for cmta, mcat and the path
mode; and each loss function alone with a ``sample_mask``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sml_tpu.config import Config as JConfig
from sml_tpu.train import losses as j_losses
from sml_tpu.train import steps as j_steps
from sml_tpu_torch.config import Config
from sml_tpu_torch.train import losses
from sml_tpu_torch.train import steps

TOL = dict(rtol=1e-4, atol=1e-4)
SURVIVAL_LOSSES = ["ce_surv", "cox_surv", "nll_surv", "nll_surv_kl", "nll_surv_mse",
                   "nll_surv_l1", "nll_surv_cos", "nll_surv_ol"]
B, K, W = 6, 4, 16


def _labels(rng):
    """(B, 12) label rows: diag2021 class at 5, event bin at 8, censorship at 9
    (both values present), survival time at 11 (with a tie)."""
    labels = np.zeros((B, 12), np.float32)
    labels[:, 5] = rng.integers(0, 4, B)
    labels[:, 8] = rng.integers(0, K, B)
    labels[:, 9] = [0, 1, 0, 1, 1, 0]
    labels[:, 11] = rng.uniform(1, 50, B).round()
    labels[1, 11] = labels[4, 11]
    return labels


def _outputs(rng, mode):
    logits = rng.normal(size=(B, K)).astype(np.float32)
    out = {"logits": logits}
    if mode in ("mcat", "cmta"):
        hazards = 1.0 / (1.0 + np.exp(-logits))
        out.update(hazards=hazards.astype(np.float32),
                   S=np.cumprod(1.0 - hazards, axis=1).astype(np.float32))
    if mode == "cmta":
        out.update({k: rng.normal(size=(B, W)).astype(np.float32)
                    for k in ("P", "P_hat", "G", "G_hat")})
    return out


@pytest.mark.parametrize("masked", [False, True], ids=["train", "eval_masked"])
@pytest.mark.parametrize("mode", ["cmta", "mcat", "path"])
@pytest.mark.parametrize("survival_loss", SURVIVAL_LOSSES)
def test_mode_loss_matches_jax(survival_loss, mode, masked):
    rng = np.random.default_rng(len(survival_loss) + 10 * len(mode) + masked)
    flags = dict(mode=mode, task_type="survival", survival_loss=survival_loss)
    out, labels = _outputs(rng, mode), _labels(rng)
    mask = np.array([1, 1, 1, 1, 0, 0], np.float32) if masked else None

    def j_total(o):
        total, aux = j_steps.compute_mode_loss(
            JConfig(**flags), o, jnp.asarray(labels), train=not masked,
            sample_mask=None if mask is None else jnp.asarray(mask))
        return total, aux

    (want, want_aux), want_grads = jax.value_and_grad(j_total, has_aux=True)(
        {k: jnp.asarray(v) for k, v in out.items()})
    t_out = {k: torch.from_numpy(v).requires_grad_(True) for k, v in out.items()}
    got, aux = steps.compute_mode_loss(
        Config(**flags), t_out, torch.from_numpy(labels), train=not masked,
        sample_mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    assert set(aux) == set(want_aux) == ({"loss3", "alignment_loss"} if mode == "cmta"
                                          else {"loss3"})
    for k in aux:
        np.testing.assert_allclose(aux[k].item(), float(want_aux[k]), err_msg=k, **TOL)
    got.backward()
    for k, t in t_out.items():
        g = np.zeros_like(out[k]) if t.grad is None else t.grad.numpy()
        np.testing.assert_allclose(g, np.asarray(want_grads[k]), err_msg=k, **TOL)


def test_eval_step_risk_is_minus_the_sum_of_the_models_s():
    """mcat and cmta hand the eval step their own S."""
    rng = np.random.default_rng(1)
    out = {k: torch.from_numpy(v) for k, v in _outputs(rng, "mcat").items()}
    out["S"] = out["S"] * 0.5                      # not cumprod(1 - sigmoid(logits))
    hazards, s = steps._hazards_and_s(Config(mode="mcat", task_type="survival"), out)
    assert torch.equal(hazards, out["hazards"]) and torch.equal(s, out["S"])
    _, s = steps._hazards_and_s(Config(mode="path", task_type="survival"),
                                {"logits": out["logits"]})
    torch.testing.assert_close(s, torch.cumprod(1 - torch.sigmoid(out["logits"]), dim=1))


def _loss_inputs(rng):
    hazards = rng.uniform(0.05, 0.95, (B, K)).astype(np.float32)
    return {"hazards": hazards, "s": np.cumprod(1 - hazards, 1).astype(np.float32),
            "labels": _labels(rng),
            "risk": rng.normal(size=B).astype(np.float32),
            "a": rng.normal(size=(B, W)).astype(np.float32),
            "b": rng.normal(size=(B, W)).astype(np.float32),
            "c": rng.normal(size=(B, W)).astype(np.float32),
            "d": rng.normal(size=(B, W)).astype(np.float32),
            "mask": np.array([1, 0, 1, 1, 1, 0], np.float32)}


LOSS_CALLS = {
    "ce_surv_loss": lambda L, x, m: L.ce_surv_loss(
        x["hazards"], x["s"], x["labels"][:, 8], x["labels"][:, 9], alpha=0.4,
        sample_mask=m),
    "cox_loss": lambda L, x, m: L.cox_loss(x["labels"][:, 11], x["labels"][:, 9], x["risk"],
                                           sample_mask=m),
    "l1_loss": lambda L, x, m: L.l1_loss(x["a"], x["b"], sample_mask=m),
    "kl_loss": lambda L, x, m: L.kl_loss(x["a"], x["b"], sample_mask=m),
    "cosine_loss": lambda L, x, m: L._masked_mean(L.cosine_loss(x["a"], x["b"]), m),
    "orthogonal_loss": lambda L, x, m: L._masked_mean(
        L.orthogonal_loss(x["a"], x["b"], x["c"], x["d"], gamma=0.5), m),
    "_cos": lambda L, x, m: L._cos(x["a"], x["b"]),
}


@pytest.mark.parametrize("name", sorted(LOSS_CALLS))
def test_loss_function_matches_jax(name):
    x = _loss_inputs(np.random.default_rng(len(name)))
    call = LOSS_CALLS[name]
    want = call(j_losses, {k: jnp.asarray(v) for k, v in x.items()}, jnp.asarray(x["mask"]))
    got = call(losses, {k: torch.from_numpy(v) for k, v in x.items()},
               torch.from_numpy(x["mask"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if name in ("l1_loss", "kl_loss", "cox_loss", "ce_surv_loss"):
        # the masked rows drop out: the same value from the valid rows alone
        valid = x["mask"] > 0
        alone = call(losses, {k: torch.from_numpy(v[valid] if v.shape[:1] == (B,) else v)
                              for k, v in x.items()}, None)
        np.testing.assert_allclose(got.numpy(), alone.numpy(), **TOL)
