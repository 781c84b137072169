"""Training orchestration (counterpart of ``sml_tpu/train/loop.py``: ``setup``,
``_is_better`` and ``train`` in their single-device, per-step form).

With ``packed_dir`` set, the splits come from its packed files through the
native prefetcher; else from the datasets, with ``bucket_sizes`` through
``BucketedLoader``s (one bucket per batch), and ``workers > 0`` collates the
train batches on a thread ahead of the step.  ``reload`` starts from
``<checkpoints>/best_modal.npz`` with a fresh optimizer; ``resume`` continues
the run that wrote ``<checkpoints>/last_state.pt`` (and starts afresh without
one).  Per epoch: the seeded
shuffled train batches, one train step each (every ``eval_every_iters``
iterations inside the epoch a Test and Val pass, logged with that step's train
metrics, else the train metrics every 10 iterations), then Test and Val
evaluation, the ``epoch i/n val=... test=...`` line and its ``MetricLogger``
record, the plateau controller, best-on-val weights written as
``<checkpoints>/best_modal.npz`` and under the reference's metric-bearing
name (the flattened flax parameter tree and the BatchNorms' ``batch_stats``,
which ``python -m sml_tpu_torch.inference --weights`` reads), and last the
whole train state and its meta (``train/checkpoint.py``).
The train metrics of an epoch stay on the device and are fetched once, at its
end, unless a log record needs them.

With ``device_loop`` the epoch's train batches go to the card in chunks of
``device_loop_chunk`` steps (0: the whole epoch; capped at the epoch, then at
its gcd with ``eval_every_iters``), each stacked and copied once
(``stack_to_device``, the next chunk's copy beside the current chunk's
steps), and run by ``make_epoch_loop``; a shorter last chunk takes the
remainder.  A mid-epoch Test / Val pass follows a chunk that ends on the
interval, logged without train metrics, and the epoch's mean train metrics
make one ``training`` record (the JAX loop's ``device_loop`` branch).

Several ranks (``parallel/``; the JAX loop over a mesh): the (data, seq) grid
is made first; the train loader yields each data rank's slice of every global
batch (``batch_size`` divided by the data ranks, which must divide it), the
eval loaders the global batches, of which each rank evaluates its rows; each
data rank draws its own dropout streams; rank 0's initial or restored state
is put on every rank; only rank 0 prints, logs and writes files, and every
epoch ends with a check that the ranks still hold the same state, bit for
bit.
"""

from __future__ import annotations

import math
import os
import time
from typing import Dict, Tuple

import numpy as np
import torch

from sml_tpu_torch.bridge import (STATS, export_flax_batch_stats, export_flax_params,
                                  flatten_params, load_npz)
from sml_tpu_torch.config import Config
from sml_tpu_torch.data.loader import BucketedLoader, Loader, build_datasets
from sml_tpu_torch.models.factory import (ReduceLROnPlateau, define_net, define_optimizer,
                                          resolve_device, set_learning_rate)
from sml_tpu_torch.ops.common import DropoutRNG
from sml_tpu_torch.parallel.collectives import barrier, fold_seed
from sml_tpu_torch.parallel.mesh import Grid, make_grid, replicas_equal, replicate_state
from sml_tpu_torch.train import checkpoint as ckpt
from sml_tpu_torch.train.evaluate import batch_to_device, evaluate, stack_to_device
from sml_tpu_torch.train.state import TrainState
from sml_tpu_torch.train.steps import make_epoch_loop, make_eval_step, make_train_step
from sml_tpu_torch.utils.logging import MetricLogger


def setup(config: Config, device: str | torch.device = "cuda"):
    """(state, train_step, eval_step, (train_loader, val_loader, test_loader));
    the state from ``best_modal.npz`` (``reload``) and then from
    ``last_state.pt`` (``resume``, where there is one), then the first rank's
    on every rank."""
    device = resolve_device(device)
    if device.type == "cuda":
        # f32 products and convolutions in full f32, as on the CPU
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    grid = make_grid(config.seq_devices)
    train_loader, val_loader, test_loader = _loaders(config, grid)
    model = define_net(config, device, train=True)
    optimizer, scheduler = define_optimizer(config, model, max(len(train_loader), 1))
    rng = DropoutRNG.from_seed(fold_seed(config.seed, grid.data_index), device)
    state = TrainState(model, optimizer, scheduler, rng)
    if config.reload:
        load_npz(model, os.path.join(config.checkpoints, "best_modal.npz"))
    if config.resume and ckpt.has_resume_state(config.checkpoints):
        ckpt.restore_train_state(os.path.join(config.checkpoints, ckpt.LAST_STATE), state)
        if grid.data_index:   # the file holds rank 0's streams: fold this rank's off them
            state.rng = DropoutRNG.from_seed(
                fold_seed(state.rng.philox_seed(), grid.data_index), device)
    replicate_state(state, grid)
    return (state, make_train_step(config, model), make_eval_step(config, model),
            (train_loader, val_loader, test_loader))


def _loaders(config: Config, grid: Grid):
    """(train, val or None, test) loaders: the packed splits of ``packed_dir``
    through the native prefetcher (``max(workers, 2)`` threads), else the
    datasets, per bag-size bucket with ``bucket_sizes``.  The train loader
    yields this data rank's slice of each global batch."""
    if config.batch_size % grid.data:
        raise ValueError(f"batch_size={config.batch_size} must be divisible by the "
                         f"{grid.data} data ranks")
    local_bs = config.batch_size // grid.data
    shards = dict(num_shards=grid.data, shard_id=grid.data_index)
    if config.packed_dir:
        if config.bucket_list():
            raise ValueError("packed_dir holds fixed-size records: bucket_sizes needs "
                             "the datasets (drop packed_dir)")
        from sml_tpu_torch.data.packed import PackedLoader

        def packed(phase, batch_size=config.batch_size, **kw):
            return PackedLoader(os.path.join(config.packed_dir, f"{phase}.bin"),
                                batch_size, workers=max(config.workers, 2), **kw)

        return (packed("Train", local_bs, shuffle=True, drop_last=True, seed=config.seed,
                       **shards),
                None if config.novalset else packed("Val"), packed("Test"))
    train_ds = build_datasets(config, "Train")
    loader_cls = Loader
    if config.bucket_list():
        # mixed bag-size buckets: every batch holds one bucket, masks keep the
        # padding exact
        if not hasattr(train_ds, "bucket_of"):
            raise ValueError(f"dataset {config.dataset!r} does not expose "
                             "bucket_of(i) metadata for bucket_sizes")
        loader_cls = BucketedLoader
        if config.device_loop:
            raise ValueError("bucket_sizes requires per-step dispatch "
                             "(device_loop scans need one static shape)")
    train_loader = loader_cls(train_ds, local_bs, shuffle=True, drop_last=True,
                              seed=config.seed, workers=config.workers, **shards)
    val_loader = (None if config.novalset
                  else loader_cls(build_datasets(config, "Val"), config.batch_size))
    return train_loader, val_loader, loader_cls(build_datasets(config, "Test"),
                                                config.batch_size)


def _is_better(config: Config, val: Dict[str, float], best: Dict[str, float]) -> bool:
    if config.task_type == "survival":
        return val["cindex"] > best.get("cindex", 0.0)
    # reference: (val_auc > best_auc) or (val_acc > best_acc)
    return (val["auc"] > best.get("auc", 0.0)) or (val["acc"] > best.get("acc", 0.0))


def save_weights(model: torch.nn.Module, path: str) -> None:
    """The model's parameters as an ``.npz`` of the flattened flax tree, and a
    BatchNorm's running averages under ``batch_stats/``."""
    stats = flatten_params(export_flax_batch_stats(model), STATS)
    np.savez(path, **flatten_params(export_flax_params(model)), **stats)


def _print(msg: str) -> None:
    """Print on rank 0 alone."""
    from sml_tpu_torch.parallel.distributed import is_primary

    if is_primary():
        print(msg, flush=True)


def _host(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v) for k, v in metrics.items()}


def train(config: Config, device: str | torch.device = "cuda"
          ) -> Tuple[TrainState, Dict[str, float]]:
    """Train to ``config.epochs`` epochs; returns (state, best val metrics +
    epoch).  The records go to ``<checkpoints>/metrics.jsonl`` (none under
    ``debug``; none but rank 0's under several ranks)."""
    from sml_tpu_torch.parallel.distributed import is_primary

    os.makedirs(config.checkpoints, exist_ok=True)
    logger = MetricLogger(config, out_dir=config.checkpoints,
                          disabled=config.debug or not is_primary())
    try:
        return _train(config, device, logger)
    finally:
        logger.close()


def _mid_epoch_eval(config: Config, evaluation: Tuple, dev: torch.device, cur_iters: int,
                    epoch_end_iters: int):
    """The Test (and Val) metrics when a mid-epoch evaluation falls after
    iteration ``cur_iters``, else None."""
    if not (config.eval_every_iters and cur_iters % config.eval_every_iters == 0
            and cur_iters < epoch_end_iters):
        return None
    eval_step, val_loader, test_loader = evaluation
    log = {"test": evaluate(config, eval_step, test_loader, dev)}
    if val_loader is not None:
        log["validation"] = evaluate(config, eval_step, val_loader, dev)
    return log


def _per_step_epoch(config: Config, state: TrainState, train_step, train_loader,
                    evaluation: Tuple, dev: torch.device, logger: MetricLogger,
                    epoch: int, cur_iters: int, epoch_end_iters: int) -> int:
    """One epoch of train steps, one per batch; returns the iteration count
    after it."""
    step_metrics = []
    for batch in train_loader:
        batch.pop("sample_mask", None)
        metrics = train_step(state, batch_to_device(config, batch, dev))
        step_metrics.append(metrics)
        cur_iters += 1
        log = _mid_epoch_eval(config, evaluation, dev, cur_iters, epoch_end_iters)
        if log is not None:
            logger.log({"training": _host(metrics), **log})
        elif cur_iters % 10 == 0:
            logger.log({"training": _host(metrics)})
    if step_metrics:
        stacked = {k: torch.stack([m[k] for m in step_metrics]).float().mean().item()
                   for k in step_metrics[0]}
        _print(f"epoch {epoch + 1}/{config.epochs} train={stacked}")
    return cur_iters


def _device_loop_epoch(config: Config, state: TrainState, epoch_loop, chunk: int,
                       train_loader, evaluation: Tuple, dev: torch.device,
                       logger: MetricLogger, epoch: int, cur_iters: int,
                       epoch_end_iters: int) -> int:
    """One epoch of the device loop, ``chunk`` steps to a stack (the last one
    shorter where the epoch leaves a remainder); returns the iteration count
    after it."""
    chunk_metrics, buf = [], []

    def dispatch(buf):
        nonlocal cur_iters
        chunk_metrics.append(epoch_loop(state, stack_to_device(config, buf, dev)))
        cur_iters += len(buf)
        log = _mid_epoch_eval(config, evaluation, dev, cur_iters, epoch_end_iters)
        if log is not None:
            logger.log(log)

    for batch in train_loader:
        batch.pop("sample_mask", None)
        buf.append(batch)
        if len(buf) == chunk:
            dispatch(buf)
            buf = []
    if buf:
        dispatch(buf)
    if chunk_metrics:
        means = {k: float(np.mean(np.concatenate([m[k].float().cpu().numpy()
                                                  for m in chunk_metrics])))
                 for k in chunk_metrics[0]}
        logger.log({"training": means})
        _print(f"epoch {epoch + 1}/{config.epochs} train={means}")
    return cur_iters


def _train(config: Config, device: str | torch.device, logger: MetricLogger
           ) -> Tuple[TrainState, Dict[str, float]]:
    state, train_step, eval_step, (train_loader, val_loader, test_loader) = setup(
        config, device)
    dev = next(state.model.parameters()).device
    grid = make_grid(config.seq_devices)
    best: Dict[str, float] = {}
    cur_iters = 0
    start = time.time()
    plateau = ReduceLROnPlateau(config.lr) if config.lr_policy == "plateau" else None

    start_epoch = config.start_epoch
    meta = ckpt.load_resume_meta(config.checkpoints) if config.resume else None
    if meta is not None:
        start_epoch = int(meta["epoch"]) + 1
        best = dict(meta.get("best", {}))
        cur_iters = int(meta.get("iters", 0))
        if plateau is not None and meta.get("plateau"):
            plateau.lr = meta["plateau"]["lr"]
            plateau.best = meta["plateau"]["best"]
            plateau.num_bad = meta["plateau"]["num_bad"]
        _print(f"resuming from epoch {start_epoch} (step {state.step})")

    if config.device_loop:
        steps_per_epoch = max(len(train_loader), 1)
        chunk = min(config.device_loop_chunk or steps_per_epoch, steps_per_epoch)
        if config.eval_every_iters:
            # chunks end on the mid-epoch evaluations
            chunk = math.gcd(chunk, config.eval_every_iters)
        epoch_loop = make_epoch_loop(config, state.model)

    for epoch in range(start_epoch, config.epochs):
        train_loader.set_epoch(epoch)
        # the epoch-end evaluation below always runs: a mid-epoch one landing
        # on the epoch's last iteration would repeat it
        epoch_end_iters = cur_iters + max(len(train_loader), 1)
        if config.device_loop:
            cur_iters = _device_loop_epoch(config, state, epoch_loop, chunk, train_loader,
                                           (eval_step, val_loader, test_loader), dev,
                                           logger, epoch, cur_iters, epoch_end_iters)
        else:
            cur_iters = _per_step_epoch(config, state, train_step, train_loader,
                                        (eval_step, val_loader, test_loader), dev,
                                        logger, epoch, cur_iters, epoch_end_iters)

        test_m = evaluate(config, eval_step, test_loader, dev)
        val_m = evaluate(config, eval_step, val_loader, dev) if val_loader else test_m
        elapsed = time.time() - start
        logger.log({"epoch": epoch, "test": test_m, "validation": val_m,
                    "elapsed_sec": elapsed})
        _print(f"epoch {epoch + 1}/{config.epochs} val={val_m} test={test_m} "
               f"elapsed_sec={elapsed:.1f}")
        if plateau is not None:
            # takes effect from the next epoch's first update
            set_learning_rate(state, plateau.step(val_m["loss"]))
        if not replicas_equal(state, grid):
            raise RuntimeError(f"epoch {epoch + 1}: the ranks' train states differ")
        # the Val metrics are the global batch's on every rank: all take one branch
        if _is_better(config, val_m, best):
            best = dict(val_m, epoch=epoch)
            if grid.primary:
                name = ckpt.best_checkpoint_name(config.checkpoints, epoch,
                                                 config.task_type, test_m)
                save_weights(state.model, name + ".npz")
                save_weights(state.model, os.path.join(config.checkpoints,
                                                       "best_modal.npz"))
        if grid.primary:
            ckpt.save_train_state(os.path.join(config.checkpoints, ckpt.LAST_STATE), state)
            meta = {"epoch": epoch, "iters": cur_iters,
                    "best": {k: float(v) for k, v in best.items()}}
            if plateau is not None:
                meta["plateau"] = {"lr": plateau.lr, "best": plateau.best,
                                   "num_bad": plateau.num_bad}
            ckpt.save_resume_meta(config.checkpoints, meta)
    if grid.active:
        barrier(dev)             # rank 0's files are written when any rank returns
    return state, best
