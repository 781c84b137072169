"""Model and optimizer factory (counterpart of ``sml_tpu/models/factory.py``:
``define_net`` with every ``init_type``, ``model_inputs``, ``make_lr_schedule``
with every ``lr_policy``, ``define_optimizer`` (adam, sgd, adagrad),
``ReduceLROnPlateau`` and ``set_learning_rate``) for all seven modes:
deformpathomic (both ``attn_dim``s, every ``fusion_type``, ``remat``), path
(ABMIL, the default ``path_arch``, and TransMIL), omic (MaxNet alone),
pathomic, pathomic_original, mcat and cmta (both ``coattn_fusion``s).

The JAX factory turns its kernels off unless the backend is a TPU; the port
has no such switch: its kernel wrappers launch their CUDA kernels whenever the
tensors are on ``cuda``.

Under several ranks (``parallel/mesh.py``'s grid) ``define_net`` hands
every BatchNorm the data group when it holds more than one rank, and with
``seq_devices > 1`` hands the sharded attentions their seq group: TransMIL's
Nystrom attentions, those of CMTA's pathomics branch (not the genomics
stream's five tokens), and deformpathomic's 2-D deformable cross-attentions.
``seq_checks`` refuses what the sharded bodies cannot split, first, as the
JAX ``_seq_mesh`` does.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch
from torch import nn

from sml_tpu_torch.bridge import _leaf_map
from sml_tpu_torch.config import Config
from sml_tpu_torch.models.cmta import CMTA
from sml_tpu_torch.models.deform import DeformPathomicNet
from sml_tpu_torch.models.mcat import MCATSurv
from sml_tpu_torch.models.maxnet import MaxNet
from sml_tpu_torch.models.mil import ABMIL, TransMIL
from sml_tpu_torch.models.pathomic import PathomicNet, PathomicNetOriginal
from sml_tpu_torch.ops.common import dtype_of, init_params
from sml_tpu_torch.ops.fusion import BatchNorm
from sml_tpu_torch.ops.nystrom import NystromAttention
from sml_tpu_torch.parallel.mesh import Grid, make_grid

# which batch keys each mode's forward consumes
MODE_INPUTS = {"path": ("x_path",),
               "omic": ("x_omic",),
               "pathomic": ("x_path", "x_omic"),
               "pathomic_original": ("x_path", "x_omic"),
               "mcat": ("x_path", "x_omic"),
               "cmta": ("x_path", "x_omic"),
               "deformpathomic": ("x_path", "x_omic_tumor", "x_omic_immune")}
# modes whose models take a per-patch validity mask (padded / bucketed bags);
# the others see a bucketed bag's padding, as in the JAX package
MASKABLE_MODES = ("path", "deformpathomic")


def resolve_device(device: str | torch.device) -> torch.device:
    """The device asked for; asking for cuda without a card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is available; "
                           "pass device='cpu' to run on the CPU")
    return device


def compute_dtype(config: Config) -> torch.dtype:
    return dtype_of(config.compute_dtype)


def feature_dtype(config: Config) -> torch.dtype:
    """dtype of the WSI feature bags (x_path) in transfer; auto = compute dtype."""
    name = config.compute_dtype if config.feature_dtype == "auto" else config.feature_dtype
    return dtype_of(name)


def seq_checks(config: Config) -> None:
    """What ``seq_devices > 1`` needs of the mode (the JAX ``_seq_mesh``'s
    checks and messages): the Nystrom landmark count divisible by it, attn_dim
    2 for deformpathomic, and a query grid side that splits into whole kv rows
    per shard (a multiple of 4 * seq_devices)."""
    if config.seq_devices <= 1:
        return
    layer_dims = []
    if config.mode == "cmta":
        layer_dims = [256]                              # CMTA feature_dim
    elif config.mode == "path" and config.path_arch == "transmil":
        layer_dims = [512]                              # TransMIL TransLayer dim
    for dim in layer_dims:
        if (dim // 2) % config.seq_devices:
            raise ValueError(
                f"seq_devices={config.seq_devices} must divide the Nystrom "
                f"landmark count {dim // 2} (TransLayer dim {dim} // 2) for "
                f"mode={config.mode!r}")
    if config.mode == "deformpathomic":
        if config.attn_dim != 2:
            raise ValueError("seq_devices requires attn_dim=2 for "
                             "deformpathomic (1-D branch is not sharded)")
        side = math.isqrt(config.fixdim - 1) + 1
        if side % (4 * config.seq_devices):
            raise ValueError(
                f"seq_devices={config.seq_devices}: the {side}x{side} query "
                f"grid must split into whole kv rows per shard — side must "
                f"be a multiple of 4*seq_devices")


def _sharded_attentions(config: Config, model: nn.Module):
    """The attention modules whose token rows a seq group splits."""
    if config.mode == "path" and config.path_arch == "transmil":
        return [model.layer1.attn, model.layer2.attn]
    if config.mode == "cmta":
        return [layer.attn for enc in (model.pathomics_encoder, model.pathomics_decoder)
                for layer in (enc.layer1, enc.layer2)]
    if config.mode == "deformpathomic":
        return [getattr(model, f"pathomic_net_{b}").layer3.attn2d for b in ("tumor", "immune")]
    return []


def attach_grid(config: Config, model: nn.Module, grid: Grid) -> None:
    """Hand the model's BatchNorms and Nystrom attentions (the pinv's scale) the
    data group (more than one data rank), and its sharded attentions the grid
    (``seq_devices > 1``)."""
    if grid.data > 1:
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.group = grid.data_group
            elif isinstance(m, NystromAttention):
                m.data_group = grid.data_group
    if config.seq_devices > 1:
        if grid.seq != config.seq_devices:
            raise ValueError(f"seq_devices={config.seq_devices} but the grid has "
                             f"{grid.seq} seq rank(s)")
        for attn in _sharded_attentions(config, model):
            attn.seq = grid


def define_net(config: Config, device: str | torch.device = "cuda",
               seed: int | None = None, train: bool = False) -> nn.Module:
    """The model on ``device`` in eval mode (``train=True``: training mode),
    seeded-initialized from ``seed`` (default ``config.seed``), then
    re-initialized by ``init_type`` unless it is max or none; parameters stay
    float32; then handed the current grid's groups (``attach_grid``)."""
    seq_checks(config)
    dtype, init_max = compute_dtype(config), config.init_type == "max"
    if config.mode == "path" and config.path_arch == "transmil":
        model = TransMIL(label_dim=config.label_dim, path_dim=config.path_dim,
                         input_path_dim=config.input_path_dim, dtype=dtype)
    elif config.mode == "path":
        model = ABMIL(label_dim=config.label_dim, path_dim=config.path_dim,
                      input_path_dim=config.input_path_dim, dtype=dtype)
    elif config.mode == "omic":
        model = MaxNet(config.input_size_omic, config.omic_dim, config.dropout_rate,
                       config.label_dim, init_max=init_max, dtype=dtype)
    elif config.mode in ("pathomic", "pathomic_original"):
        cls = PathomicNet if config.mode == "pathomic" else PathomicNetOriginal
        model = cls(label_dim=config.label_dim, input_size_omic=config.input_size_omic,
                    input_path_dim=config.input_path_dim, path_dim=config.path_dim,
                    omic_dim=config.omic_dim, mmhid=config.mmhid,
                    dropout_rate=config.dropout_rate, fusion_type=config.fusion_type,
                    cut_fuse_grad=config.cut_fuse_grad, skip=config.skip,
                    use_bilinear=config.use_bilinear, gate1=config.path_gate,
                    gate2=config.omic_gate, path_scale=config.path_scale,
                    omic_scale=config.omic_scale, init_max=init_max, dtype=dtype)
    elif config.mode == "mcat":
        model = MCATSurv(label_dim=config.label_dim, input_path_dim=config.input_path_dim,
                         fusion=config.coattn_fusion, dtype=dtype)
    elif config.mode == "cmta":
        model = CMTA(label_dim=config.label_dim, input_path_dim=config.input_path_dim,
                     fusion=config.coattn_fusion, dtype=dtype)
    elif config.mode == "deformpathomic":
        model = DeformPathomicNet(
            label_dim=config.label_dim,
            input_size_omic_tumor=config.input_size_omic_tumor,
            input_size_omic_immune=config.input_size_omic_immune,
            input_path_dim=config.input_path_dim, path_dim=config.path_dim,
            omic_dim=config.omic_dim, mmhid=config.mmhid,
            dropout_rate=config.dropout_rate, attn_dim=config.attn_dim,
            return_vgrid=config.return_vgrid, fusion_type=config.fusion_type,
            cut_fuse_grad=config.cut_fuse_grad, task_type=config.task_type,
            init_max=init_max, skip=config.skip, use_bilinear=config.use_bilinear,
            path_scale=config.path_scale, omic_scale=config.omic_scale,
            remat=config.remat, dtype=dtype)
    else:
        raise ValueError(f"unknown mode {config.mode!r}")
    seed = config.seed if seed is None else seed
    init_params(model, seed)
    if config.init_type not in ("max", "none"):
        reinit_params(model, config.init_type, config.init_gain,
                      torch.Generator().manual_seed(seed))
    attach_grid(config, model, make_grid(config.seq_devices))
    device = resolve_device(device)
    return model.to(device).train(train)


def model_inputs(config: Config, batch: Dict[str, Any]) -> Dict[str, Any]:
    kwargs = {k: batch[k] for k in MODE_INPUTS[config.mode]}
    if "mask" in batch and config.mode in MASKABLE_MODES:
        kwargs["mask"] = batch["mask"]
    return kwargs


def _fans(shape) -> Tuple[int, int]:
    """flax's ``variance_scaling`` fans of a kernel (in_axis -2, out_axis -1):
    each times the product of the other axes."""
    receptive = math.prod(shape[:-2]) if len(shape) > 2 else 1
    return shape[-2] * receptive, shape[-1] * receptive


def _orthogonal(shape, gain: float, generator: torch.Generator) -> torch.Tensor:
    """flax ``orthogonal(scale=gain, column_axis=-1)``: the Q of a normal
    matrix's QR, signed by R's diagonal, its columns (or rows, when there are
    fewer rows than columns) orthonormal along the last axis."""
    n_cols = shape[-1]
    n_rows = math.prod(shape) // n_cols
    tall = n_rows >= n_cols
    a = torch.randn((n_rows, n_cols) if tall else (n_cols, n_rows), generator=generator,
                    dtype=torch.float64)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    q = q if tall else q.T
    return (gain * q).reshape(shape)


def _init_kernel(shape, init_type: str, gain: float,
                 generator: torch.Generator) -> torch.Tensor:
    """A kernel of the flax ``shape`` drawn by ``init_type`` (JAX
    ``_init_kernel``; the normals are untruncated)."""
    if init_type == "orthogonal":
        return _orthogonal(shape, gain, generator)
    fan_in, fan_out = _fans(shape)
    std = {"normal": gain,
           "xavier": gain * math.sqrt(2.0 / (fan_in + fan_out)),
           "kaiming": math.sqrt(2.0 / fan_in)}[init_type]
    return std * torch.randn(shape, generator=generator, dtype=torch.float64)


def reinit_params(model: nn.Module, init_type: str, gain: float,
                  generator: torch.Generator) -> None:
    """JAX ``_reinit_kernels`` on the flax layout: every leaf named ``kernel``
    or ``weight`` with two axes or more is redrawn there (then mapped to the
    torch layout), every ``bias`` is zeroed, everything else stays."""
    with torch.no_grad():
        for key, (p, to_torch, to_flax) in sorted(_leaf_map(model).items()):
            name = key.rsplit("/", 1)[-1]
            if name in ("kernel", "weight") and p.dim() >= 2:
                flax_shape = to_flax(np.empty(p.shape, np.float32)).shape
                w = to_torch(_init_kernel(flax_shape, init_type, gain, generator).numpy())
                p.copy_(torch.from_numpy(np.ascontiguousarray(w)).to(p.dtype))
            elif name == "bias":
                p.zero_()


def make_lr_schedule(config: Config, steps_per_epoch: int) -> Callable[[int], float]:
    """Learning rate of update ``k`` (from 0): torch's per-epoch schedulers as a
    function of the step count, ``lr * mult(k // steps_per_epoch)``; onecycle
    is optax's ``cosine_onecycle_schedule`` of ``k`` itself (torch's
    OneCycleLR at max_lr 1e-3 over (epochs + epochs_decay) * 200 steps), which
    takes neither ``lr`` nor ``steps_per_epoch``.  plateau is constant here:
    ``ReduceLROnPlateau`` moves it between epochs."""
    lr0, policy, epochs = config.lr, config.lr_policy, config.epochs
    if policy == "onecycle":
        return _onecycle((config.epochs + config.epochs_decay) * 200, peak=1e-3,
                         pct_start=0.3, div_factor=25.0, final_div_factor=1e4)
    if policy == "linear":
        def mult(epoch: int) -> float:
            return 1.0 - max(0, epoch + config.epoch_count - epochs) / float(
                config.epochs_decay + 1)
    elif policy == "exp":
        def mult(epoch: int) -> float:
            return 0.1 ** epoch
    elif policy == "step":
        def mult(epoch: int) -> float:
            return 0.1 ** (epoch // config.lr_decay_iters)
    elif policy == "cosine":
        def mult(epoch: int) -> float:
            return 0.5 * (1.0 + math.cos(math.pi * epoch / epochs))
    else:                                                   # none, plateau
        def mult(epoch: int) -> float:
            return 1.0

    def schedule(k: int) -> float:
        return lr0 * mult(k // max(steps_per_epoch, 1))

    return schedule


def _onecycle(total: int, peak: float, pct_start: float, div_factor: float,
              final_div_factor: float) -> Callable[[int], float]:
    """optax ``cosine_onecycle_schedule``: from peak / div_factor up to peak
    over the first ``int(pct_start * total)`` steps, then down to
    peak / (div_factor * final_div_factor) at ``total``, cosine-interpolated;
    constant after."""
    bounds = (0, int(pct_start * total), int(total))
    v0 = peak / div_factor
    values = (v0, v0 * div_factor, v0 * div_factor / (div_factor * final_div_factor))

    def schedule(k: int) -> float:
        for i in range(2):
            if bounds[i] <= k < bounds[i + 1]:
                pct = (k - bounds[i]) / (bounds[i + 1] - bounds[i])
                start, end = values[i], values[i + 1]
                return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1.0)
        return values[-1]

    return schedule


ADAGRAD_INIT = 0.1  # optax scale_by_rss's initial_accumulator_value
ADAGRAD_EPS = 1e-7


class Adagrad(torch.optim.Optimizer):
    """optax ``scale_by_rss(initial_accumulator_value=0.1, eps=1e-7)`` then
    ``-lr``: p -= lr * g / sqrt(sum g^2 + eps), the sum starting at 0.1, with
    coupled weight decay (g + wd * p first).  torch's Adagrad divides by
    sqrt(sum) + 1e-10 instead."""

    def __init__(self, params, lr: float, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if group["weight_decay"]:
                    g = g + group["weight_decay"] * p
                state = self.state[p]
                if not state:
                    state["sum"] = torch.full_like(p, ADAGRAD_INIT)
                acc = state["sum"]
                acc.add_(g * g)
                p.add_(g * torch.rsqrt(acc + ADAGRAD_EPS), alpha=-group["lr"])


def define_optimizer(config: Config, model: nn.Module, steps_per_epoch: int = 1
                     ) -> Tuple[torch.optim.Optimizer, torch.optim.lr_scheduler.LambdaLR]:
    """The optimizer with coupled L2 (``weight_decay`` added to the gradient
    before the optimizer's core, as ``optax.add_decayed_weights``): Adam,
    SGD with momentum 0.9 (``optax.trace(0.9)``) or ``Adagrad``; and the
    per-step ``make_lr_schedule`` as a ``LambdaLR``.  Call ``scheduler.step()``
    after every ``optimizer.step()``.  Under plateau the schedule is constant
    and ``set_learning_rate`` moves its base."""
    params, lr, wd = model.parameters(), config.lr, config.weight_decay
    if config.optimizer == "adam":
        optimizer = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                     weight_decay=wd)
    elif config.optimizer == "sgd":
        optimizer = torch.optim.SGD(params, lr=lr, momentum=0.9, dampening=0.0,
                                    weight_decay=wd)
    else:
        optimizer = Adagrad(params, lr=lr, weight_decay=wd)
    schedule = make_lr_schedule(config, steps_per_epoch)
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda k: schedule(k) / config.lr)
    return optimizer, scheduler


PLATEAU_FACTOR = 0.2
PLATEAU_THRESHOLD = 0.01  # relative
PLATEAU_PATIENCE = 5


class ReduceLROnPlateau:
    """Host-side torch ``ReduceLROnPlateau(mode='min', factor=0.2,
    threshold=0.01, patience=5)`` in relative-threshold mode (JAX
    ``ReduceLROnPlateau``): ``step(metric)`` returns the new learning rate."""

    def __init__(self, lr: float):
        self.lr = lr
        self.best = float("inf")
        self.num_bad = 0

    def step(self, metric: float) -> float:
        if metric < self.best * (1.0 - PLATEAU_THRESHOLD):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.num_bad > PLATEAU_PATIENCE:
            self.lr *= PLATEAU_FACTOR
            self.num_bad = 0
        return self.lr


def set_learning_rate(state, lr: float) -> None:
    """Set the learning rate of every later update (``lr_policy='plateau'``):
    the scheduler's base, which each ``scheduler.step()`` writes back into the
    optimizer, and the optimizer's groups for the next update."""
    state.scheduler.base_lrs = [lr] * len(state.optimizer.param_groups)
    for group in state.optimizer.param_groups:
        group["lr"] = lr
