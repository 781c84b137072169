"""Typed config with the keys and defaults of ``config/config_mine.yaml``, and an
argparse parser built from its fields (counterpart of ``sml_tpu/config.py``).

No YAML dependency: the defaults live in the dataclass.  Every field becomes a
``--field`` flag whose type follows its default; booleans parse leniently, and
a bare boolean flag (``--debug``, as the JAX parser's ``store_true`` flag)
means true.
"""

from __future__ import annotations

import argparse
import dataclasses

MODES = ("path", "omic", "pathomic", "pathomic_original", "mcat", "cmta",
         "deformpathomic")
TASKS = ("diag2021", "survival", "grade", "subtype")
LR_POLICIES = ("linear", "exp", "step", "plateau", "cosine", "onecycle", "none")
OPTIMIZERS = ("sgd", "adam", "adagrad")
INIT_TYPES = ("max", "normal", "xavier", "kaiming", "orthogonal", "none")


@dataclasses.dataclass
class Config:
    # --- dataset ---
    fixdim: int = 2500
    label_path: str = "./data"
    dataDir: str = "./data/"
    dataset: str = "synthetic"
    checkpoints: str = "./checkpoints"
    novalset: bool = False
    synthetic_size: int = 256
    bucket_sizes: str = ""
    variable_bags: bool = False
    packed_dir: str = ""                # {Train,Val,Test}.bin from sml_tpu_torch.pack_data

    # --- distributed / host ---
    coordinator_address: str = ""       # "host:port" of rank 0's rendezvous; "" =
                                        # MASTER_ADDR:MASTER_PORT, else one process
    num_processes: int = 0              # ranks in all; 0 = WORLD_SIZE
    process_id: int = -1                # this rank; -1 = RANK
    workers: int = 0
    data_axis: str = "data"
    num_devices: int = 0
    seq_devices: int = 0                # ranks sharing one batch, each holding a
                                        # share of the Nystrom / 2-D deformable
                                        # attentions' token rows (0 / 1 = off)

    # --- modality fusion ---
    fusion_type: str = "concat"
    coattn_fusion: str = "concat"
    skip: int = 0
    use_bilinear: int = 1
    input_size_omic: int = 431
    input_size_omic_tumor: int = 59
    input_size_omic_immune: int = 361
    input_path_dim: int = 1024
    path_gate: int = 1
    omic_gate: int = 1
    path_dim: int = 128
    omic_dim: int = 128
    path_scale: int = 1
    omic_scale: int = 1
    mmhid: int = 128
    cut_fuse_grad: bool = False

    # --- training ---
    reload: bool = False
    resume: bool = False                # continue from <checkpoints>/last_state.pt
    seed: int = 42
    batch_size: int = 8
    image_size: tuple = (224, 224)      # as in JAX, read by nothing (patches are
                                        # 224 x 224); parsed as JAX parses a tuple
                                        # flag: tuple(str), one item per character
    start_epoch: int = 0
    epochs: int = 20
    lr: float = 1.0e-3
    lr_policy: str = "cosine"
    lr_decay_iters: int = 50
    epoch_count: int = 1
    epochs_decay: int = 10
    dropout_rate: float = 0.1
    return_grad: bool = False
    optimizer: str = "adam"
    weight_decay: float = 0.1
    init_type: str = "max"
    init_gain: float = 0.02
    compute_dtype: str = "float32"      # float32 | bfloat16
    feature_dtype: str = "auto"         # x_path transfer dtype; auto = compute_dtype
    use_pallas: bool = True             # kept for key parity; the port always
                                        # launches its kernels on cuda tensors
    eval_every_iters: int = 0
    remat: bool = False
    device_loop: bool = False           # train steps over stacked chunks of batches
    device_loop_chunk: int = 0          # steps per chunk; 0 = the whole epoch

    # --- losses ---
    gradient_modulate: bool = True
    modulation_style: str = "reference"
    return_vgrid: bool = True
    batchloss_grad_scale: str = "exact"
    survival_loss: str = "nll_surv"
    batchloss_layout: str = "group"     # group | reference

    # --- model ---
    mode: str = "deformpathomic"
    attn_dim: int = 2
    path_arch: str = "abmil"            # path-mode backbone: abmil | transmil

    # --- task ---
    task_type: str = "diag2021"
    label_dim: int = 4
    survival_interval: str = "all"
    act_type: str = "Sigmoid"

    debug: bool = False                 # no metrics.jsonl (and no wandb)

    def __post_init__(self) -> None:
        if self.mode not in MODES:
            raise ValueError(f"unknown mode {self.mode!r}")
        if self.task_type not in TASKS:
            raise ValueError(f"unknown task_type {self.task_type!r}")
        for key, allowed in (("lr_policy", LR_POLICIES), ("optimizer", OPTIMIZERS),
                             ("init_type", INIT_TYPES)):
            if getattr(self, key) not in allowed:
                raise ValueError(f"unknown {key} {getattr(self, key)!r}")
        if self.attn_dim not in (1, 2):
            raise ValueError("attn_dim must be 1 or 2")
        if self.batchloss_grad_scale not in ("exact", "ddp"):
            raise ValueError(f"unknown batchloss_grad_scale {self.batchloss_grad_scale!r}")
        if self.attn_dim == 1 and self.return_vgrid:
            raise ValueError("attn_dim=1 has no vgrid (1-D deformable attention): "
                             "set return_vgrid=false")

    def bucket_list(self) -> tuple:
        """Parsed ``bucket_sizes`` (sorted), or () when bucketing is off."""
        if not self.bucket_sizes:
            return ()
        return tuple(sorted(int(b) for b in str(self.bucket_sizes).split(",")))


def _parse_bool(s: str) -> bool:
    return str(s).lower() in ("1", "true", "yes", "y", "on")


def build_parser() -> argparse.ArgumentParser:
    """``--field`` flags for every Config field (type from the default)."""
    parser = argparse.ArgumentParser()
    for f in dataclasses.fields(Config):
        if isinstance(f.default, bool):
            parser.add_argument(f"--{f.name}", default=f.default, type=_parse_bool,
                                nargs="?", const=True)
        else:
            parser.add_argument(f"--{f.name}", default=f.default, type=type(f.default))
    return parser
