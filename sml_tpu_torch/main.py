"""Train entry point of the port (counterpart of the JAX package's ``main.py``).

Usage:
    python -m sml_tpu_torch.main --dataset synthetic --fixdim 2500 \\
        --compute_dtype bfloat16 --epochs 20 [--checkpoints DIR] [--device cuda]

Every ``Config`` field is a flag.  Runs on ``cuda`` unless ``--device cpu`` is
given; asking for cuda without a card raises.  Prints the mean train metrics
and the ``epoch i/n val=... test=...`` line of each epoch, writes the
best-on-val weights to ``<checkpoints>/best_modal.npz`` and ends with
``best (val): {...}``.
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

    from sml_tpu_torch.train.loop import train

    _, best = train(config, device)
    print(f"\nbest (val): {best}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
