"""Pack a dataset's splits into the binary format of the packed loader
(counterpart of the JAX package's ``scripts/pack_data.py``: the same flags,
the same files).

Usage:
    python -m sml_tpu_torch.pack_data --dataset both --dataDir /path/to/data/ \\
        --out ./packed --fixdim 2500
    python -m sml_tpu_torch.main --packed_dir ./packed ...

Writes ``{Train,Test,Val}.bin`` and their ``.json`` sidecars (no Val with
``--novalset``).
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    from sml_tpu_torch.config import Config
    from sml_tpu_torch.data.loader import build_datasets
    from sml_tpu_torch.data.packed import pack_dataset

    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="synthetic")
    ap.add_argument("--dataDir", default="./data/")
    ap.add_argument("--out", default="./packed")
    ap.add_argument("--fixdim", type=int, default=2500)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--synthetic_size", type=int, default=256)
    ap.add_argument("--novalset", action="store_true")
    args = ap.parse_args(argv)

    config = Config(dataset=args.dataset, dataDir=args.dataDir, fixdim=args.fixdim,
                    seed=args.seed, synthetic_size=args.synthetic_size,
                    novalset=args.novalset)
    os.makedirs(args.out, exist_ok=True)
    for phase in ["Train", "Test"] + ([] if args.novalset else ["Val"]):
        path = os.path.join(args.out, f"{phase}.bin")
        meta = pack_dataset(build_datasets(config, phase), path)
        print(f"{phase}: {meta['n_records']} records x {meta['record_bytes']} B -> {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
