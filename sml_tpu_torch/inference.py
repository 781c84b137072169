"""Serving entry point of the port: evaluate a model on the Test split.

Usage:
    python -m sml_tpu_torch.inference --dataset synthetic --fixdim 2500 \\
        --compute_dtype bfloat16 [--weights params.npz] [--device cuda]
    python -m sml_tpu_torch.inference --mode path --path_arch transmil ...
        [--variable_bags true --bucket_sizes 1024,2500,4096]

``--mode`` is any of the seven (deformpathomic by default; path with
``--path_arch transmil`` for TransMIL; mcat and cmta, the survival models
of ``--task_type survival``); with ``--bucket_sizes`` the Test split is
batched per bucket.

``--weights`` is an ``.npz`` of the flattened flax parameter tree ('/'-joined
keys, see ``sml_tpu_torch.bridge``); without it the model takes a seeded init
from ``--seed``.  Runs on ``cuda`` unless ``--device cpu`` is given.  Prints
``test metrics: {...}`` like the JAX package's ``inference.py``.
"""

from __future__ import annotations

import sys

from sml_tpu_torch.config import Config, build_parser


def main(argv=None) -> int:
    parser = build_parser()
    parser.add_argument("--weights", default="", type=str,
                        help=".npz of the flattened flax param tree ('/'-joined keys)")
    parser.add_argument("--device", default="cuda", type=str,
                        help="torch device: cuda (default) or cpu")
    args = vars(parser.parse_args(argv))
    weights, device = args.pop("weights"), args.pop("device")
    config = Config(**args)

    import torch

    from sml_tpu_torch.bridge import load_npz
    from sml_tpu_torch.data.loader import BucketedLoader, Loader, build_datasets
    from sml_tpu_torch.models.factory import define_net, resolve_device
    from sml_tpu_torch.train.evaluate import evaluate
    from sml_tpu_torch.train.steps import make_eval_step

    device = resolve_device(device)
    if device.type == "cuda":
        # f32 products and convolutions in full f32, as on the CPU
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    loader_cls = BucketedLoader if config.bucket_list() else Loader
    test_loader = loader_cls(build_datasets(config, "Test"), config.batch_size)
    model = define_net(config, device)
    if weights:
        load_npz(model, weights)
    metrics = evaluate(config, make_eval_step(config, model), test_loader, device)
    print(f"test metrics: {metrics}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
