"""Train entry point of the port (counterpart of the JAX package's ``main.py``).

Usage:
    python -m sml_tpu_torch.main --dataset synthetic --fixdim 2500 \\
        --compute_dtype bfloat16 --epochs 20 [--checkpoints DIR] [--device cuda]
    python -m sml_tpu_torch.main --mode path --path_arch transmil ...
        [--variable_bags true --bucket_sizes 1024,2500,4096]

Every ``Config`` field is a flag (a bare boolean flag means true); ``--mode``
is any of the seven
(deformpathomic by default; path with ``--path_arch transmil`` for TransMIL;
mcat and cmta, the survival models of ``--task_type survival``), and
``--bucket_sizes`` batches every split per bag-size bucket.  Runs on
``cuda`` unless ``--device cpu`` is given; asking for cuda without a card
raises.  Prints the mean train metrics and the ``epoch i/n val=...
test=...`` line of each epoch, and ends with ``best (val): {...}``.  Writes
to ``<checkpoints>``: ``metrics.jsonl`` (not under ``--debug``), the
best-on-val weights as ``best_modal.npz`` and under the reference's
``epoch_{e}_AUC_..._.npz`` / ``epoch_{e}_cindex_..._.npz`` name, and after
every epoch ``last_state.pt`` and ``last_state_meta.json``, from which
``--resume true`` continues the run; ``--reload true`` starts from
``best_modal.npz``.

Several processes, one device each (``sml_tpu_torch/parallel``), are
launched with the same flags plus ``--num_processes W --process_id R
--coordinator_address host:port`` each (or by torchrun, whose variables
stand in for the three); ``--seq_devices S`` makes every S ranks share a
batch and split its attentions' token rows.  Without a coordinator the
process trains alone.
"""

from __future__ import annotations

import sys

from sml_tpu_torch.config import Config, build_parser


def main(argv=None) -> int:
    parser = build_parser()
    parser.add_argument("--device", default="cuda", type=str,
                        help="torch device: cuda (default) or cpu")
    args = vars(parser.parse_args(argv))
    device = args.pop("device")
    config = Config(**args)

    from sml_tpu_torch.parallel import distributed

    device = distributed.initialize(config, device)
    try:
        from sml_tpu_torch.train.loop import train

        _, best = train(config, device)
        if distributed.is_primary():
            print(f"\nbest (val): {best}")
    finally:
        distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
