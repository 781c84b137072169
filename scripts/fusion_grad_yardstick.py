"""How far one f32 train step's gradients of a model with a BilinearFusion head
(deformpathomic or pathomic, ``fusion_type`` pofusion) lie from a float64
evaluation, for the JAX package and for the port, by batch size (CPU only;
both packages on the same weights).

    JAX_PLATFORMS=cpu python scripts/fusion_grad_yardstick.py [--batch_sizes 3,8]
        [--mode deformpathomic|pathomic] [--omic_dim 32]

The float64 evaluation is the port's model in float64 through the plain
versions of its kernels.  Prints one JSON line per batch size: the largest
absolute distance of each package's gradients from it, and the leaf where it
falls.  The train-mode BatchNorm amplifies f32 rounding where a feature's
batch spread is small, which is what sets the batch size of the deformpathomic
fusion cases in tests/test_torch_fusion_modes.py.
"""

import argparse
import contextlib
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sml_tpu.config import Config as JConfig  # noqa: E402
from sml_tpu.data.loader import Loader as JLoader  # noqa: E402
from sml_tpu.data.loader import build_datasets as j_build_datasets  # noqa: E402
from sml_tpu.models.factory import define_net as j_define_net  # noqa: E402
from sml_tpu.models.factory import init_model as j_init_model  # noqa: E402
from sml_tpu.train import steps as j_steps  # noqa: E402
from sml_tpu_torch.bridge import _leaf_map, flatten_params, load_flax_params  # noqa: E402
from sml_tpu_torch.config import Config  # noqa: E402
from sml_tpu_torch.models.factory import define_net  # noqa: E402
from sml_tpu_torch.train.evaluate import batch_to_device  # noqa: E402
from sml_tpu_torch.train.steps import make_grad_step  # noqa: E402

SMALL = dict(dataset="synthetic", fixdim=64, synthetic_size=16, input_path_dim=64,
             path_dim=32, mmhid=32, dropout_rate=0.0, fusion_type="pofusion")


@contextlib.contextmanager
def _float64(model):
    """The model computing in float64 through the plain kernel versions."""
    import sml_tpu_torch.ops.deformable as deformable
    from sml_tpu_torch.ops.kernels import cpb_bias_plain, deform_attention_fwd_plain

    for m in model.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = torch.float64
    to_float = torch.Tensor.float
    saved = deformable.cpb_bias_trainable, deformable.deform_attention_trainable
    torch.Tensor.float = lambda self: self.double()
    deformable.cpb_bias_trainable = cpb_bias_plain
    deformable.deform_attention_trainable = (
        lambda q, k, v, bias=None, keep_prob=1.0, seed=0: deform_attention_fwd_plain(q, k, v,
                                                                                    bias))
    try:
        yield model.double()
    finally:
        torch.Tensor.float = to_float
        deformable.cpb_bias_trainable, deformable.deform_attention_trainable = saved


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch_sizes", default="3,8")
    parser.add_argument("--mode", default="deformpathomic")
    parser.add_argument("--omic_dim", default=32, type=int)
    args = parser.parse_args()
    small = dict(SMALL, mode=args.mode, omic_dim=args.omic_dim)
    for bs in (int(b) for b in args.batch_sizes.split(",")):
        jcfg = JConfig(**small, batch_size=bs, use_pallas=False)
        jmodel = j_define_net(jcfg)
        batch = next(iter(JLoader(j_build_datasets(jcfg, "Train"), bs, shuffle=True,
                                  drop_last=True, seed=jcfg.seed)))
        batch.pop("sample_mask")
        variables = j_init_model(jcfg, jmodel, jax.random.PRNGKey(11), batch)
        params = jax.tree_util.tree_map_with_path(
            lambda p, v: np.asarray(v) + (0.02 if "bias" in str(p[-1]) else 0.0),
            variables["params"])
        stats = variables["batch_stats"]
        jb = {k: jnp.asarray(v) for k, v in batch.items()}

        def loss_fn(p):
            out, _ = j_steps._forward(jcfg, jmodel, {"params": p, "batch_stats": stats}, jb,
                                      jax.random.PRNGKey(0), train=True)
            return j_steps.compute_mode_loss(jcfg, out, jb["labels"], train=True)[0]

        g_jax = flatten_params(jax.tree_util.tree_map(np.asarray, jax.grad(loss_fn)(params)))
        cfg = Config(**small, batch_size=bs)
        grads = {}
        for name in ("f32", "f64"):
            model = define_net(cfg, "cpu", seed=0, train=True)
            load_flax_params(model, {"params": params, "batch_stats": stats})
            tb = batch_to_device(cfg, batch, torch.device("cpu"))
            ctx = _float64(model) if name == "f64" else contextlib.nullcontext(model)
            with ctx as m:
                if name == "f64":
                    tb = {k: v.double() if v.is_floating_point() else v for k, v in tb.items()}
                make_grad_step(cfg, m)(tb, None)
            grads[name] = {k: f(p.grad.double().numpy())
                           for k, (p, _, f) in _leaf_map(model).items()}
        ref = grads["f64"]
        row = {"mode": args.mode, "omic_dim": args.omic_dim, "batch_size": bs}
        for name, g in (("jax_f32", g_jax), ("port_f32", grads["f32"])):
            err = {k: float(np.abs(g[k] - ref[k]).max()) for k in ref}
            worst = max(err, key=err.get)
            row[name] = {"max_abs_from_f64": err[worst], "leaf": worst}
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
