"""Serving entry point of the port: evaluate a model on the Test split.

Usage:
    python -m sml_tpu_torch.inference --dataset synthetic --fixdim 2500 \\
        --compute_dtype bfloat16 [--weights params.npz] [--device cuda]
    python -m sml_tpu_torch.inference --dataset both --dataDir D --mode pathomic \\
        --weights CKPT/best_modal.npz --checkpoints CKPT --attribution ablation
    python -m sml_tpu_torch.inference --mode path --path_arch transmil ...
        [--variable_bags true --bucket_sizes 1024,2500,4096]

``--mode`` is any of the seven (deformpathomic by default; path with
``--path_arch transmil`` for TransMIL; mcat and cmta, the survival models
of ``--task_type survival``); with ``--bucket_sizes`` the Test split is
batched per bucket.

``--weights`` is an ``.npz`` of the flattened flax parameter tree ('/'-joined
keys, see ``sml_tpu_torch.bridge``); without it the model takes a seeded init
from ``--seed``.  Runs on ``cuda`` unless ``--device cpu`` is given.  Prints
``test metrics: {...}`` like the JAX package's ``inference.py`` and logs them
to ``<checkpoints>/metrics.jsonl`` (not under ``--debug``).

``--attribution`` then attributes the predictions to the genes of the Test
split and writes ``<checkpoints>/difference_acc_list.csv`` (ablation) or
``gene_importance.csv`` (the others), one ``gene_index,importance`` row per
gene, and an ``attribution`` record to ``metrics.jsonl``: ``ablation`` and
``permutation``, ``gradient_shap`` and ``deep_shap`` for the modes with a
whole gene vector (omic, pathomic, pathomic_original, mcat, cmta; deep_shap
omic and pathomic only), ``mcat_groups`` for mcat.

Several ranks take the train CLI's flags (``--num_processes``,
``--process_id``, ``--coordinator_address``, ``--seq_devices``; or torchrun's
variables): each data rank scores its rows of every Test batch, all get the
global metrics, and rank 0 prints and logs them.  ``--attribution`` runs in
one process.
"""

from __future__ import annotations

import os
import sys

from sml_tpu_torch.config import Config, build_parser


ATTRIBUTIONS = ("", "mcat_groups", "ablation", "permutation", "gradient_shap",
                "deep_shap")


def main(argv=None) -> int:
    parser = build_parser()
    parser.add_argument("--weights", default="", type=str,
                        help=".npz of the flattened flax param tree ('/'-joined keys)")
    parser.add_argument("--device", default="cuda", type=str,
                        help="torch device: cuda (default) or cpu")
    parser.add_argument("--attribution", default="", type=str, choices=ATTRIBUTIONS,
                        help="gene attribution after the evaluation: mcat_groups "
                             "(integrated gradients per signature group, --mode mcat), "
                             "ablation (accuracy drop of each zeroed gene), "
                             "permutation (score drop of each shuffled gene), "
                             "gradient_shap (expected gradients) or deep_shap (exact "
                             "DeepLIFT through MaxNet or the fused pathomic head)")
    args = vars(parser.parse_args(argv))
    weights, device = args.pop("weights"), args.pop("device")
    attribution = args.pop("attribution")
    config = Config(**args)

    from sml_tpu_torch.parallel import distributed

    device = distributed.initialize(config, device)
    try:
        return _serve(config, weights, device, attribution)
    finally:
        distributed.shutdown()


def _serve(config: Config, weights: str, device, attribution: str) -> int:
    import numpy as np
    import torch

    from sml_tpu_torch.bridge import load_npz
    from sml_tpu_torch.data.loader import BucketedLoader, Loader, build_datasets
    from sml_tpu_torch.models.factory import define_net, resolve_device
    from sml_tpu_torch.parallel.mesh import make_grid
    from sml_tpu_torch.train.evaluate import evaluate
    from sml_tpu_torch.train.steps import make_eval_step
    from sml_tpu_torch.utils.logging import MetricLogger

    device = resolve_device(device)
    if device.type == "cuda":
        # f32 products and convolutions in full f32, as on the CPU
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    grid = make_grid(config.seq_devices)
    if attribution and grid.world > 1:
        raise ValueError("--attribution runs in one process (drop --num_processes)")
    loader_cls = BucketedLoader if config.bucket_list() else Loader
    test_loader = loader_cls(build_datasets(config, "Test"), config.batch_size)
    model = define_net(config, device)
    if weights:
        load_npz(model, weights)
    eval_step = make_eval_step(config, model)
    metrics = evaluate(config, eval_step, test_loader, device)
    if grid.primary:
        print(f"test metrics: {metrics}")

    if not config.debug:
        os.makedirs(config.checkpoints, exist_ok=True)
    logger = MetricLogger(config, out_dir=config.checkpoints,
                          disabled=config.debug or not grid.primary)
    try:
        logger.log({"test": metrics})
        if attribution == "mcat_groups":
            if config.mode != "mcat":
                raise ValueError("--attribution mcat_groups requires --mode mcat")
            from sml_tpu_torch.models.mcat import OMIC_SIZES
            from sml_tpu_torch.utils.importance import mcat_group_attribution

            per_gene, per_group = mcat_group_attribution(model, list(test_loader))
            out_csv = _write_gene_csv(config.checkpoints, "gene_importance.csv", per_gene)
            print("per-signature-group |IG| attribution of survival risk "
                  f"(groups of {OMIC_SIZES} genes): "
                  f"{np.array2string(per_group, precision=6)}")
            print(f"per-gene attribution written to {out_csv}")
            logger.log({"attribution": {"groups": [float(v) for v in per_group]}})
        elif attribution:
            per_gene = _gene_attribution(config, model, eval_step, test_loader,
                                         attribution, device)
            name = ("difference_acc_list.csv" if attribution == "ablation"
                    else "gene_importance.csv")  # the reference's file names
            out_csv = _write_gene_csv(config.checkpoints, name, per_gene)
            print(f"{attribution} attribution over {len(per_gene)} genes "
                  f"written to {out_csv} (top gene: {int(per_gene.argmax())})")
            logger.log({"attribution": {attribution: float(per_gene.max())}})
    finally:
        logger.close()
    return 0


def _write_gene_csv(out_dir: str, name: str, values) -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name)
    with open(path, "w") as f:
        f.write("gene_index,importance\n")
        for i, v in enumerate(values):
            f.write(f"{i},{v}\n")
    return path


def _gene_attribution(config: Config, model, eval_step, test_loader, kind: str, device):
    """Whole-gene-vector attribution over the Test split's real samples:

    ablation      the accuracy drop of each zeroed gene (classification tasks)
    permutation   the mean score drop over 3 shuffles of each gene (accuracy,
                  or the C-index for survival)
    gradient_shap expected gradients against the Test split as background, of
                  the true class's log-probability (survival: the summed risk)
    deep_shap     exact DeepLIFT through MaxNet (omic) or the fused pathomic
                  head, averaged over the classes
    """
    import numpy as np
    import torch

    from sml_tpu_torch.models.factory import model_inputs
    from sml_tpu_torch.train.evaluate import batch_to_device
    from sml_tpu_torch.train.losses import TASK_LABEL_SLOT
    from sml_tpu_torch.train.metrics import cindex
    from sml_tpu_torch.utils import importance as imp

    if config.mode in ("deformpathomic", "path"):
        raise ValueError(f"--attribution {kind} needs a whole-omic-vector mode "
                         "(omic/pathomic/pathomic_original/mcat/cmta)")

    batches, labels = [], []
    for b in test_loader:
        mask = np.asarray(b["sample_mask"]) > 0
        hb = {k: np.asarray(v)[mask] for k, v in b.items() if k != "sample_mask"}
        if len(hb["labels"]):
            batches.append(hb)
            labels.append(hb["labels"])
    labels = np.concatenate(labels)
    # each batch crosses to the device once; a perturbation sends its genes only
    dev_batches = [batch_to_device(config, b, device) for b in batches]

    def run(i, omic):
        """The eval step's outputs on batch ``i`` with the gene vector ``omic``."""
        x_omic = torch.from_numpy(np.ascontiguousarray(omic, np.float32)).to(device)
        out = eval_step({**dev_batches[i], "x_omic": x_omic})
        return {k: v.cpu().numpy() for k, v in out.items()}

    if kind == "ablation":
        if config.task_type == "survival":
            raise ValueError("--attribution ablation scores accuracy; use a "
                             "classification task (reference semantics)")
        gt = labels[:, TASK_LABEL_SLOT[config.task_type]].astype(int)
        tagged = [dict(b, batch_index=i) for i, b in enumerate(batches)]
        return imp.ablation_importance(
            lambda b: run(b["batch_index"], b["x_omic"])["probs"], tagged, gt)

    if kind == "permutation":
        omic = np.concatenate([b["x_omic"] for b in batches])
        sizes = [len(b["x_omic"]) for b in batches]

        def score(x):
            outs, off = [], 0
            for i, n in enumerate(sizes):
                outs.append(run(i, x[off:off + n]))
                off += n
            if config.task_type == "survival":
                risk = np.concatenate([o["risk"] for o in outs])
                return float(cindex(risk, labels[:, 9], labels[:, 11]))
            preds = np.concatenate([np.argmax(o["probs"], -1) for o in outs])
            return float((preds == labels[:, TASK_LABEL_SLOT[config.task_type]]).mean())

        _, decreases = imp.get_score_importances(score, omic, seed=config.seed)
        return decreases.mean(axis=0)

    if kind == "gradient_shap":
        background = np.concatenate([b["x_omic"] for b in batches])
        slot = TASK_LABEL_SLOT.get(config.task_type)
        model.eval()

        def loss_fn(omic, batch):
            out = model(**model_inputs(config, {**batch, "x_omic": omic}))
            logits = out["logits"].float()
            if config.task_type == "survival":
                hazards = out["hazards"] if "hazards" in out else torch.sigmoid(logits)
                s = out["S"] if "S" in out else torch.cumprod(1.0 - hazards, dim=1)
                return (-s.sum(dim=1)).sum()              # the summed risk
            logp = torch.log_softmax(logits, dim=1)
            y = batch["labels"][:, slot].long()
            return logp.gather(1, y[:, None]).sum()

        attrs = [imp.gradient_shap(loss_fn, b, background, seed=config.seed)
                 for b in dev_batches]
        return np.abs(np.concatenate(attrs)).mean(axis=0)

    if kind == "deep_shap":
        if config.mode not in ("omic", "pathomic", "pathomic_original"):
            raise ValueError("--attribution deep_shap runs the exact DeepLIFT "
                             "chain through MaxNet (--mode omic) or the fused "
                             "PathomicNet head (--mode pathomic[_original]); "
                             "gradient_shap covers the other modes")
        background = np.concatenate([b["x_omic"] for b in batches])
        path_vecs = []
        if config.mode != "omic":
            model.eval()
            with torch.inference_mode():
                for b in dev_batches:
                    out = model(x_path=b["x_path"], x_omic=b["x_omic"])
                    path_vecs.append(out["path_vec"].float().cpu().numpy())
        per_class = []
        for c in range(config.label_dim):
            if config.mode == "omic":
                attrs = [imp.deep_shap_maxnet(model, b["x_omic"], background,
                                              class_index=c) for b in batches]
            else:
                attrs = [imp.deep_shap_pathomic(model, b["x_omic"], background, pv,
                                                class_index=c,
                                                fusion_type=config.fusion_type,
                                                skip=config.skip)
                         for b, pv in zip(batches, path_vecs)]
            per_class.append(np.abs(np.concatenate(attrs)).mean(axis=0))
        return np.mean(per_class, axis=0)

    raise ValueError(kind)


if __name__ == "__main__":
    sys.exit(main())
