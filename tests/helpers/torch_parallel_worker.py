"""Rank body of the port's multi-process CPU tests; it imports torch and the
port only, so no rank pays for ``import jax``.

    python tests/helpers/torch_parallel_worker.py RANK WORLD PORT SPEC_JSON

Joins a gloo group of WORLD ranks on 127.0.0.1:PORT, makes the (data, seq)
grid of the spec's ``seq``, runs the spec's ``tasks`` on the inputs in
``<dir>/inputs.npz`` and writes what each returns to ``<dir>/rank{RANK}.npz``.
Every task takes this rank's rows itself, so the test writes global inputs.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

TASKS = {}


def task(fn):
    TASKS[fn.__name__] = fn
    return fn


def _rows(x: np.ndarray, index: int, parts: int) -> np.ndarray:
    per = x.shape[0] // parts
    return x[index * per:(index + 1) * per]


def train_step(flags: dict, weights: str, batch: dict, steps: int = 1):
    """(the model's state dict after ``steps`` train steps on ``batch`` and the
    gradients of the last one, under ``grad/``; the train state; the metrics
    of the last step; whether the ranks' states were bit-equal after every
    step) for the current grid: the port's ``setup`` without its loaders."""
    from sml_tpu_torch.bridge import load_npz
    from sml_tpu_torch.config import Config
    from sml_tpu_torch.models.factory import define_net, define_optimizer
    from sml_tpu_torch.ops.common import DropoutRNG
    from sml_tpu_torch.parallel.collectives import fold_seed
    from sml_tpu_torch.parallel.mesh import make_grid, replicas_equal, replicate_state
    from sml_tpu_torch.train.evaluate import batch_to_device
    from sml_tpu_torch.train.state import TrainState
    from sml_tpu_torch.train.steps import make_train_step

    config = Config(**flags)
    grid = make_grid(config.seq_devices)
    model = define_net(config, "cpu", seed=0, train=True)
    load_npz(model, weights)
    optimizer, scheduler = define_optimizer(config, model, 1)
    state = TrainState(model, optimizer, scheduler,
                       DropoutRNG.from_seed(fold_seed(config.seed, grid.data_index), "cpu"))
    replicate_state(state, grid)
    step = make_train_step(config, model)
    local = {k: _rows(v, grid.data_index, grid.data) for k, v in batch.items()}
    equal = []
    for _ in range(steps):
        metrics = step(state, batch_to_device(config, local, torch.device("cpu")))
        equal.append(replicas_equal(state, grid))
    tensors = {k: v.detach().clone() for k, v in model.state_dict().items()}
    tensors.update({f"grad/{k}": p.grad.clone() for k, p in model.named_parameters()})
    return tensors, state, {k: float(v) for k, v in metrics.items()}, all(equal)


@task
def gather(grid, inputs, spec):
    """``gather_with_local_grad`` of this rank's rows of ``gather_x``, and the
    gradient of sum(gathered * gather_w) at them."""
    from sml_tpu_torch.parallel.collectives import gather_with_local_grad

    x = torch.from_numpy(_rows(inputs["gather_x"], grid.data_index, grid.data))
    x.requires_grad_(True)
    y = gather_with_local_grad(x, grid.data_group)
    (y * torch.from_numpy(inputs["gather_w"])).sum().backward()
    return {"gather_y": y.detach().numpy(), "gather_dx": x.grad.numpy()}


@task
def batchnorm(grid, inputs, spec):
    """``SyncBatchNorm`` over the data group on this rank's rows of ``bn_x``:
    its output, the gradients of sum(y * bn_w) (the parameters' summed over
    the group) and the running averages after the step."""
    from sml_tpu_torch.parallel.batchnorm import SyncBatchNorm
    from sml_tpu_torch.parallel.collectives import all_reduce

    bn = SyncBatchNorm(inputs["bn_x"].shape[1], group=grid.data_group)
    with torch.no_grad():
        bn.scale.copy_(torch.from_numpy(inputs["bn_scale"]))
        bn.bias.copy_(torch.from_numpy(inputs["bn_bias"]))
    x = torch.from_numpy(_rows(inputs["bn_x"], grid.data_index, grid.data))
    x.requires_grad_(True)
    y = bn(x)
    (y * torch.from_numpy(_rows(inputs["bn_w"], grid.data_index, grid.data))).sum().backward()
    return {"bn_y": y.detach().numpy(), "bn_dx": x.grad.numpy(),
            "bn_dscale": all_reduce(bn.scale.grad, grid.data_group).numpy(),
            "bn_dbias": all_reduce(bn.bias.grad, grid.data_group).numpy(),
            "bn_mean": bn.mean.numpy(), "bn_var": bn.var.numpy()}


@task
def pinv(grid, inputs, spec):
    """``moore_penrose_pinv`` of this rank's rows of ``pinv_x`` with the scale
    over the data group, and the gradient of sum(pinv * pinv_w) at them."""
    from sml_tpu_torch.ops.linear_algebra import moore_penrose_pinv

    x = torch.from_numpy(_rows(inputs["pinv_x"], grid.data_index, grid.data))
    x.requires_grad_(True)
    z = moore_penrose_pinv(x, 6, grid.data_group)
    w = torch.from_numpy(_rows(inputs["pinv_w"], grid.data_index, grid.data))
    (z * w).sum().backward()
    return {"pinv_z": z.detach().numpy(), "pinv_dx": x.grad.numpy()}


@task
def steps(grid, inputs, spec):
    """For each of the spec's ``steps`` ({name, flags, weights, steps}): the
    parameters after the train steps on the global batch ``batch/*``, the
    last step's loss, whether the ranks were bit-equal after every step and,
    with dropout, this rank's training-mode logits of the batch's first rows
    (another draw on each data rank)."""
    batch = {k.split("/", 1)[1]: v for k, v in inputs.items() if k.startswith("batch/")}
    out = {}
    for run in spec["steps"]:
        params, state, metrics, equal = train_step(run["flags"], run["weights"], batch,
                                                   run.get("steps", 1))
        name = run["name"]
        out.update({f"{name}/{k}": v.numpy() for k, v in params.items()})
        out[f"{name}:loss"] = np.float64(metrics["loss"])
        out[f"{name}:equal"] = np.bool_(equal)
        if run["flags"].get("dropout_rate", 0.1) > 0:
            from sml_tpu_torch.config import Config
            from sml_tpu_torch.models.factory import model_inputs
            from sml_tpu_torch.train.evaluate import batch_to_device

            config = Config(**run["flags"])
            first = batch_to_device(config, {k: v[:2] for k, v in batch.items()},
                                    torch.device("cpu"))
            state.model.train()
            with torch.no_grad():
                logits = state.model(**model_inputs(config, first), rng=state.rng)["logits"]
            out[f"{name}:dropout_logits"] = logits.float().numpy()
    return out


@task
def seq_attention(grid, inputs, spec):
    """The sharded Nystrom and 2-D deformable attentions of the spec's
    ``attention`` ({kind, module kwargs, weights npz, masked, fused}) on the
    global inputs ``<kind>_x`` (and ``deform_x2``), each seq group alike: the
    output (and the vgrid), the input gradients and every parameter gradient
    of sum(out * w) (+ sum(vgrid * vw)); with ``fused`` the Nystrom chain 1 is
    routed to the kernels whatever its shape, and ``:chain1`` counts the
    kernel wrapper's calls."""
    from unittest import mock

    from sml_tpu_torch.bridge import _leaf_map, load_npz
    from sml_tpu_torch.ops import nystrom
    from sml_tpu_torch.ops.deformable import DeformCrossAttention2D
    from sml_tpu_torch.parallel import seq_parallel

    out = {}
    for case in spec["attention"]:
        kind, name = case["kind"], case["name"]
        cls = nystrom.NystromAttention if kind == "nystrom" else DeformCrossAttention2D
        mod = cls(**case["kwargs"])
        load_npz(mod, case["weights"])
        mod.seq = grid
        mask = torch.from_numpy(inputs[f"{kind}_mask"]) if case["masked"] else None
        x = torch.from_numpy(inputs[f"{kind}_x"]).requires_grad_(True)
        if kind == "nystrom":
            route = mock.patch.object(nystrom, "fused_chains_supported",
                                      lambda *a: bool(case["fused"]))
            calls = mock.patch.object(seq_parallel, "deform_attention_trainable",
                                      wraps=seq_parallel.deform_attention_trainable)
            with route, calls as chain1:
                y = mod(x, mask=mask)
            out[f"{name}:chain1"] = np.int64(chain1.call_count)
            loss = (y * torch.from_numpy(inputs["nystrom_w"])).sum()
            grads_of = [x]
        else:
            x2 = torch.from_numpy(inputs["deform_x2"]).requires_grad_(True)
            y, vgrid = mod(x, x2, return_vgrid=True, mask=mask)
            loss = ((y * torch.from_numpy(inputs["deform_w"])).sum()
                    + (vgrid * torch.from_numpy(inputs["deform_vw"])).sum())
            out[f"{name}:vgrid"] = vgrid.detach().numpy()
            grads_of = [x, x2]
        loss.backward()
        out[f"{name}:out"] = y.detach().numpy()
        for i, t in enumerate(grads_of):
            out[f"{name}:dx{i}"] = t.grad.numpy()
        for key, (p, _, to_flax) in _leaf_map(mod).items():
            out[f"{name}/{key}"] = to_flax(p.grad.numpy())
    return out


def main() -> int:
    rank, world, port, spec_path = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                    sys.argv[4])
    torch.set_num_threads(1)
    with open(spec_path) as f:
        spec = json.load(f)
    import torch.distributed as dist

    from sml_tpu_torch.parallel.mesh import make_grid

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        grid = make_grid(spec.get("seq", 0))
        inputs = dict(np.load(os.path.join(spec["dir"], "inputs.npz")))
        out = {}
        for name in spec["tasks"]:
            out.update(TASKS[name](grid, inputs, spec))
        np.savez(os.path.join(spec["dir"], f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())


def start(world: int, spec: dict):
    """Start WORLD ranks of this file on ``spec`` (written to
    ``<dir>/spec.json``); ``finish`` waits for them."""
    import socket
    import subprocess

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    path = os.path.join(spec["dir"], "spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), str(world),
                               str(port), path], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    return procs, spec["dir"]


def finish(started, timeout: float = 120.0) -> list:
    """Each rank's outputs (``rank{r}.npz``) once all have exited.  Each rank's
    wait has its own timeout: a hang kills them all and fails."""
    import subprocess

    procs, out_dir = started
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise AssertionError(f"a rank hung past {timeout} s")
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode:
            raise AssertionError(f"rank {r} exited {p.returncode}:\n{log[-4000:]}")
    return [dict(np.load(os.path.join(out_dir, f"rank{r}.npz"))) for r in range(len(procs))]
