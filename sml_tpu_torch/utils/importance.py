"""Gene feature importance (counterpart of ``sml_tpu/utils/importance.py``; the
reference's L7: ``utils/feature_importance.py``, ``utils/permutation_importance.py``,
``utils/metrics.py:199-232``).

Every gene is measured, where the reference's ablation loop stops at two.
The gradient estimators differentiate the port's model with
``torch.autograd.grad`` in eval mode; the host draws their random numbers in
the JAX package's order, so both packages attribute from the same baselines.
The exact DeepLIFT estimators read the model's weights in the flax layout
(``bridge.export_flax_params``), so their arithmetic is the JAX package's
line for line.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sml_tpu_torch.bridge import export_flax_batch_stats, export_flax_params

IG_STEPS = 16        # integrated gradients: points on the path from zero
SHAP_SAMPLES = 32    # expected gradients: (baseline, alpha) draws per sample
SECANT_EPS = 1e-6    # DeepLIFT: |z - z_ref| below which the derivative is used
PERMUTATION_ROUNDS = 3   # permutation importance: shuffles of each column


def iter_shuffled(x: np.ndarray, pre_shuffle: bool = False, seed: int = 0
                  ) -> Iterable[Tuple[int, np.ndarray]]:
    """Yield (column, copy of x with that column shuffled) for every column,
    eli5-style (reference ``utils/permutation_importance.py:20-58``)."""
    rng = np.random.default_rng(seed)
    if pre_shuffle:
        # drawn (on a copy that is not read) so that the column permutations
        # below follow the JAX package's stream
        rng.shuffle(x.copy())
    for col in range(x.shape[1]):
        out = x.copy()
        perm = rng.permutation(x.shape[0])
        out[:, col] = x[perm, col]
        yield col, out


def get_score_importances(score_func: Callable[[np.ndarray], float], x: np.ndarray,
                          seed: int = 0) -> Tuple[float, np.ndarray]:
    """Permutation importance: the score's decrease when each column is
    shuffled, PERMUTATION_ROUNDS times (reference
    ``utils/permutation_importance.py:61-100``).  Returns (base_score,
    decreases[PERMUTATION_ROUNDS, n_columns])."""
    base_score = score_func(x)
    decreases = np.zeros((PERMUTATION_ROUNDS, x.shape[1]))
    for it in range(PERMUTATION_ROUNDS):
        for j, shuffled in iter_shuffled(x, seed=seed + it):
            decreases[it, j] = base_score - score_func(shuffled)
    return base_score, decreases


def _grad(loss_fn: Callable, omic: torch.Tensor, batch) -> torch.Tensor:
    point = omic.detach().requires_grad_(True)
    return torch.autograd.grad(loss_fn(point, batch), point)[0]


def gradient_importance(loss_fn: Callable, batch: Dict) -> np.ndarray:
    """Integrated gradients from a zero baseline: (d loss / d x_omic) averaged
    over IG_STEPS points of the straight path, times the input; per gene, the
    batch's mean of the absolute values.  ``loss_fn(omic, batch)`` -> scalar."""
    omic = torch.as_tensor(batch["x_omic"])
    total = torch.zeros_like(omic)
    for k in range(1, IG_STEPS + 1):
        total = total + _grad(loss_fn, omic * (k / IG_STEPS), batch)
    ig = omic * total / IG_STEPS
    return np.abs(ig.detach().cpu().numpy()).mean(axis=0)


def gradient_shap(loss_fn: Callable, batch: Dict, background: np.ndarray,
                  seed: int = 0) -> np.ndarray:
    """Expected-gradients SHAP (``shap.GradientExplainer``'s estimator): the mean
    over SHAP_SAMPLES draws of (baseline x' from ``background``, alpha ~ U(0,
    1)) of ``(x - x') * dloss/dx`` at ``x' + alpha (x - x')``, x the batch's
    ``x_omic``.  ``loss_fn(omic, batch)`` is summed over the batch, so the
    gradient rows are per sample.  Returns (B, genes)."""
    rng = np.random.default_rng(seed)
    omic = torch.as_tensor(batch["x_omic"])
    total = torch.zeros_like(omic)
    for _ in range(SHAP_SAMPLES):
        idx = rng.integers(0, len(background), size=omic.shape[0])
        baseline = torch.as_tensor(background[idx]).to(omic)
        alpha = torch.as_tensor(rng.uniform(size=(omic.shape[0], 1)).astype(np.float32)
                                ).to(omic)
        point = baseline + alpha * (omic - baseline)
        total = total + (omic - baseline) * _grad(loss_fn, point, batch)
    return (total / SHAP_SAMPLES).detach().cpu().numpy()


def _secant(fn, z, z_ref, dfn):
    """The DeepLIFT rescale multiplier (f(z) - f(z_ref)) / (z - z_ref), or the
    derivative at the midpoint where |z - z_ref| <= SECANT_EPS."""
    dz = z - z_ref
    far = dz.abs() > SECANT_EPS
    sec = (fn(z) - fn(z_ref)) / torch.where(far, dz, torch.ones_like(dz))
    return torch.where(far, sec, dfn((z + z_ref) / 2.0))


def _d_elu(z):
    return torch.where(z > 0, torch.ones_like(z), torch.exp(z))


def _d_relu(z):
    return (z > 0).to(z.dtype)


def _d_sigmoid(z):
    return torch.sigmoid(z) * (1 - torch.sigmoid(z))


def _tree(model: torch.nn.Module, device: torch.device) -> Dict:
    """The model's parameters (and BatchNorm statistics under ``batch_stats``)
    as a flax-layout tree of f32 tensors on ``device``."""
    def to(t):
        return ({k: to(v) for k, v in t.items()} if isinstance(t, dict)
                else torch.as_tensor(t, device=device))
    return {"params": to(export_flax_params(model)),
            "batch_stats": to(export_flax_batch_stats(model))}


def deep_shap_maxnet(model: torch.nn.Module, x: np.ndarray, background: np.ndarray,
                     class_index: int = 0) -> np.ndarray:
    """Exact Deep-SHAP (the DeepLIFT rescale rule, ``shap.DeepExplainer``'s
    estimator for an MLP) through the MaxNet genomic MLP ``model``: the secant
    multipliers of each ELU and the final ReLU composed through the Dense
    layers, averaged over the background references.  Per (sample,
    reference) the attributions sum to ``logit(x) - logit(ref)``.
    x (B, D), background (R, D) -> (B, D) for ``class_index``'s logit."""
    device = next(model.parameters()).device
    params = _tree(model, device)["params"]
    enc = [params[f"encoder{i}"] for i in range(1, 5)]
    wc = params["classifier"]["kernel"][:, class_index]
    refs = torch.as_tensor(background, device=device)
    out = []
    for xi in torch.as_tensor(x, device=device):
        zs, zrs = [], []
        h, hr = xi[None], refs                       # (1, D), (R, D)
        for layer in enc:                            # Dense -> ELU (eval: no dropout)
            z = h @ layer["kernel"] + layer["bias"]
            zr = hr @ layer["kernel"] + layer["bias"]
            zs.append(z)
            zrs.append(zr)
            h, hr = F.elu(z), F.elu(zr)
        m = wc * _secant(torch.relu, h, hr, _d_relu)          # (R, width)
        for layer, z, zr in zip(reversed(enc), reversed(zs), reversed(zrs)):
            m = m * _secant(F.elu, z, zr, _d_elu)
            m = m @ layer["kernel"].T
        out.append((m * (xi[None] - refs)).mean(dim=0))
    return torch.stack(out).cpu().numpy()


def deep_shap_pathomic(model: torch.nn.Module, x_omic: np.ndarray,
                       background: np.ndarray, path_vec: np.ndarray,
                       class_index: int = 0, fusion_type: str = "pofusion",
                       skip: int = 0) -> np.ndarray:
    """Exact Deep-SHAP through a pathomic model: MaxNet -> fusion -> classifier,
    with the path branch held at its value (``path_vec``, the model's own
    ``out["path_vec"]``: equal in input and reference, so it is given no
    attribution).

    Each intermediate is a triple (value, reference, contributions) whose
    contributions (D, width) sum over the genes to value - reference; linear
    maps (Dense, eval-mode BatchNorm, a bilinear form with one constant side)
    carry the contributions through, an elementwise nonlinearity multiplies
    them by its rescale secant, and a product of two tracked streams (the
    gates, the outer product) takes the multilinear-Shapley rule
    ``d(ab) = da (b + b_ref) / 2 + db (a + a_ref) / 2``.  ``fusion_type``
    concat, add or pofusion (with ``skip``); BatchNorm from its running
    averages.  x_omic (B, D), background (R, D), path_vec (B, path_dim) ->
    (B, D) for ``class_index``'s logit, averaged over references."""
    device = next(model.parameters()).device
    tree = _tree(model, device)
    params, bstats = tree["params"], tree["batch_stats"]
    enc = [params["omic_net"][f"encoder{i}"] for i in range(1, 5)]
    d = x_omic.shape[-1]
    # a triple holds one sample against every reference at once: value and
    # reference (R, width), contributions (R, D, width)

    def t_const(v, n):
        v = v.expand(n, -1)
        return (v, v, torch.zeros((n, d, v.shape[-1]), device=device))

    def t_lin(t, k, b=None):
        val, ref, con = t
        aff = lambda u: u @ k + (0.0 if b is None else b)
        return (aff(val), aff(ref), con @ k)

    def t_scale(t, scale, shift=0.0):
        val, ref, con = t
        return (val * scale + shift, ref * scale + shift, con * scale)

    def t_nl(t, fn, dfn):
        val, ref, con = t
        return (fn(val), fn(ref), con * _secant(fn, val, ref, dfn)[:, None, :])

    def t_mul(a, b):
        av, ar, ac = a
        bv, br, bc = b
        return (av * bv, ar * br,
                ac * ((bv + br) / 2)[:, None, :] + bc * ((av + ar) / 2)[:, None, :])

    def t_cat(ts):
        return tuple(torch.cat([t[i] for t in ts], dim=-1) for i in range(3))

    def t_bn(t, name):
        p, s = params["fusion"][name], bstats["fusion"][name]
        inv = 1.0 / torch.sqrt(s["var"] + 1e-5)
        return t_scale(t, p["scale"] * inv, p["bias"] - s["mean"] * inv * p["scale"])

    def gate(idx, v_self, vec1, vec2):
        """o_idx of BilinearFusion in eval mode: relu(W_o(sig(z) * relu(W_h v)))."""
        fp = params["fusion"]
        h = t_nl(t_lin(v_self, fp[f"linear_h{idx}"]["kernel"],
                       fp[f"linear_h{idx}"]["bias"]), torch.relu, _d_relu)
        zp = fp[f"linear_z{idx}"]
        if "weight" in zp:                        # nn.Bilinear
            # vec1 (the path side) is equal in input and reference, so the
            # bilinear form is linear in vec2: K[j, o] = sum_i v1_i W_oij
            k_eff = torch.einsum("i,oij->jo", vec1[0][0], zp["weight"])
            z = t_lin(vec2, k_eff, zp["bias"])
        else:                                     # the concat-linear gate
            z = t_lin(t_cat([vec1, vec2]), zp["kernel"], zp["bias"])
        g = t_nl(z, torch.sigmoid, _d_sigmoid)
        return t_nl(t_lin(t_mul(g, h), fp[f"linear_o{idx}"]["kernel"],
                          fp[f"linear_o{idx}"]["bias"]), torch.relu, _d_relu)

    def one_sample(xi, refs, pvec):
        n = refs.shape[0]
        t = (xi.expand(n, -1), refs, torch.diag_embed(xi - refs))   # con = diag(delta)
        for layer in enc:                         # MaxNet: Dense -> ELU (x4)
            t = t_nl(t_lin(t, layer["kernel"], layer["bias"]), F.elu, _d_elu)
        omic = t_nl(t, torch.relu, _d_relu)       # features = relu(.)
        path = t_const(pvec, n)
        if fusion_type == "concat":
            fused = t_cat([path, omic])
        elif fusion_type == "add":
            fused = tuple(p + o for p, o in zip(path, omic))
        else:                                     # pofusion: BilinearFusion
            vec1 = t_nl(path, torch.relu, _d_relu)
            vec2 = t_nl(omic, torch.relu, _d_relu)
            one = t_const(torch.ones((1,), device=device), n)
            o1 = t_cat([gate(1, vec1, vec1, vec2), one])
            o2 = t_cat([gate(2, vec2, vec1, vec2), one])
            # the outer product o12[i, j] = o1_i * o2_j: multilinear-Shapley rule
            a_v, a_r, a_c = o1
            b_v, b_r, b_c = o2
            o12 = ((a_v[:, :, None] * b_v[:, None, :]).reshape(n, -1),
                   (a_r[:, :, None] * b_r[:, None, :]).reshape(n, -1),
                   (a_c[..., None] * ((b_v + b_r) / 2)[:, None, None, :]
                    + ((a_v + a_r) / 2)[:, None, :, None] * b_c[:, :, None, :]
                    ).reshape(n, d, -1))
            fp = params["fusion"]
            fused = t_nl(t_bn(t_lin(o12, fp["encoder1"]["kernel"], fp["encoder1"]["bias"]),
                              "bn1"), torch.relu, _d_relu)
            if skip:
                fused = t_cat([fused, o1, o2])
            fused = t_nl(t_bn(t_lin(fused, fp["encoder2"]["kernel"],
                                    fp["encoder2"]["bias"]), "bn2"), torch.relu, _d_relu)
        con = t_lin(fused, params["classifier"]["kernel"], params["classifier"]["bias"])[2]
        return con[:, :, class_index].mean(dim=0)

    refs, xs, pvecs = (torch.as_tensor(np.array(a, np.float32), device=device)
                       for a in (background, x_omic, path_vec))
    return torch.stack([one_sample(xi, refs, pv) for xi, pv in zip(xs, pvecs)]
                       ).cpu().numpy()


def mcat_group_attribution(model: torch.nn.Module, batches: List[Dict[str, np.ndarray]]
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-signature-group attribution through the MCAT co-attention stack
    (the reference's ``MCAT_Surv.captum``, ``models/model.py:669-705``):
    integrated gradients of the risk ``-sum(S)`` with respect to the gene
    vector, from a zero baseline (IG_STEPS points), summed per signature
    group (``OMIC_SIZES``).  ``batches`` hold numpy arrays (with
    ``sample_mask`` where rows are padding).  Returns (per_gene, per_group):
    mean |IG| over the real samples."""
    from sml_tpu_torch.models.mcat import OMIC_SIZES

    device = next(model.parameters()).device
    model.eval()

    def risk_sum(omic, batch):
        out = model(x_path=batch["x_path"], x_omic=omic)
        s = out.get("S", torch.cumprod(1.0 - out["hazards"], dim=1))
        return (-s.sum(dim=1)).sum()

    per_gene_totals, n_samples = None, 0
    for batch in batches:
        mask = np.asarray(batch.get("sample_mask", np.ones(len(batch["x_omic"]), bool))) > 0
        dev_batch = {"x_path": torch.as_tensor(batch["x_path"], device=device)}
        omic = torch.as_tensor(batch["x_omic"], device=device)
        total = torch.zeros_like(omic)
        for k in range(1, IG_STEPS + 1):
            total = total + _grad(risk_sum, omic * (k / IG_STEPS), dev_batch)
        ig = np.abs((omic * total / IG_STEPS).detach().cpu().numpy())[mask]
        per_gene_totals = (ig.sum(axis=0) if per_gene_totals is None
                           else per_gene_totals + ig.sum(axis=0))
        n_samples += int(mask.sum())

    per_gene = per_gene_totals / max(n_samples, 1)
    bounds = np.cumsum([0, *OMIC_SIZES])
    per_group = np.asarray([per_gene[bounds[i]:bounds[i + 1]].sum()
                            for i in range(len(OMIC_SIZES))])
    return per_gene, per_group


def ablation_importance(predict_probs: Callable[[Dict[str, np.ndarray]], np.ndarray],
                        batches: List[Dict[str, np.ndarray]], labels: np.ndarray
                        ) -> np.ndarray:
    """Zero gene i of ``x_omic`` and measure the accuracy's drop over the set
    (reference ``ablation_epochVal``, ``utils/metrics.py:199-232``, for every
    gene).  ``predict_probs``: batch dict -> (B, C) probabilities.  Returns the
    accuracy difference per gene (positive: the gene mattered)."""

    def accuracy(transform) -> float:
        preds = []
        for batch in batches:
            b = dict(batch)
            b["x_omic"] = transform(np.asarray(b["x_omic"]))
            preds.append(np.argmax(predict_probs(b), -1))
        preds = np.concatenate(preds)
        return float((preds == labels[: len(preds)]).mean())

    base_acc = accuracy(lambda g: g)
    diffs = []
    for i in range(batches[0]["x_omic"].shape[1]):
        def zero_gene(g, i=i):
            g = g.copy()
            g[:, i] = 0
            return g

        diffs.append(base_acc - accuracy(zero_gene))
    return np.asarray(diffs)
