#!/usr/bin/env python3
"""How far the port's plain CPB backward in bf16 lies from the Pallas kernel's.

    JAX_PLATFORMS=cpu python scripts/cpb_bwd_yardstick.py

For the shapes of ``tests/test_torch_kernels_bwd.py``, ``cpb_bias_bwd_plain``
with bf16 weights and dbias against ``jax.vjp`` of the interpret-mode
``cpb_bias_trainable`` in bf16, on the test's raw inputs and on the inputs
snapped so that the Pallas kernel's bf16 layer 1 rounds only where the port
rounds h1 (``_bf16_exact_layer1``); each with the backward's bf16 rounding
points ("rounded") and without them ("control": the same weights handed over
as f32).  One JSON line per case: each gradient's relative L2 error and its
largest error in bf16 ulps.  CPU only; the numbers are arithmetic, not timings.
"""

import json
import sys
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")

import torch  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tests"))

from test_torch_kernels_bwd import (_bf16_exact_layer1, _cpb_errors,  # noqa: E402
                                    _cpb_inputs, _pallas_cpb_vjp_bf16, _t)
import numpy as np  # noqa: E402

from sml_tpu_torch.ops.kernels import cpb_bias_bwd_plain  # noqa: E402

SHAPES = ((2, 8, 8, 16, 32), (3, 5, 7, 9, 16), (2, 6, 6, 4, 8))


def main() -> int:
    for bg, h, w, j, dm in SHAPES:
        raw = _cpb_inputs(bg * h + dm + 1, bg, h, w, j, dm)
        dbias = np.random.default_rng(dm).normal(size=(bg, h, w * j)).astype(np.float32)
        tdbias = torch.from_numpy(dbias).bfloat16()
        for inputs, args in (("raw", raw), ("exact_layer1", _bf16_exact_layer1(raw))):
            want = _pallas_cpb_vjp_bf16(args, dbias)
            targs = _t(args[:2]) + [torch.from_numpy(a).bfloat16() for a in args[2:8]]
            runs = {"rounded": cpb_bias_bwd_plain(*targs, tdbias),
                    "control": cpb_bias_bwd_plain(*targs[:2], *(a.float() for a in targs[2:]),
                                                  tdbias.float())}
            for name, got in runs.items():
                errors = _cpb_errors(got, want)
                print(json.dumps({"shape": [bg, h, w, j, dm], "inputs": inputs, "run": name,
                                  "rel_l2": {k: float(f"{v[0]:.3g}") for k, v in errors.items()},
                                  "max_ulps": {k: float(f"{v[1]:.3g}")
                                               for k, v in errors.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
