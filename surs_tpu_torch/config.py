"""Configuration for the PyTorch port.

The port's own copy of the ``SuRSConfig`` fields and ``build_parser`` of
``surs_tpu/config.py`` (flag names and defaults unchanged, so command
lines carry over), plus the port's own resolution of the ``auto``
performance knobs: the JAX package keys them on ``jax.default_backend()``
(``surs_tpu/config.py:286-295``); here they key on the torch device.
Every knob value of the JAX package has a ported path; an unknown value
raises ``ValueError``.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import torch


def _f(default) -> object:
    return field(default_factory=lambda: list(default))


@dataclass
class SuRSConfig:
    # ---- Data ----
    dataroot: str = "./data"
    loadSize: int = 512

    # ---- Experiment ----
    name: str = "example"
    debug: bool = False
    num_views: int = 1
    random_multiview: bool = False

    # ---- Training ----
    gpu_id: int = 0
    gpu_ids: str = "0"
    num_threads: int = 1
    num_workers: int = 0
    serial_batches: bool = False
    pin_memory: bool = False
    batch_size: int = 2
    learning_rate: float = 1e-3
    learning_rateC: float = 1e-3
    num_epoch: int = 100
    freq_plot: int = 10
    freq_save: int = 50
    freq_save_ply: int = 100
    scale: int = 2
    rgb_range: int = 255
    no_gen_mesh: bool = False
    no_num_eval: bool = False
    resume_epoch: int = -1
    continue_train: int = -1

    # ---- Testing ----
    resolution: int = 512
    test_folder_path: Optional[str] = None

    # ---- Sampling ----
    sigma: float = 5.0
    num_sample_inout: int = 6000
    num_sample_color: int = 0
    z_size: float = 200.0

    # ---- Model ----
    norm: str = "group"
    norm_color: str = "instance"
    hg_depth: int = 2
    hg_dim: int = 256
    num_stack_lr: int = 3
    num_stack_hr: int = 1
    num_hourglass: int = 2
    skip_hourglass: bool = False
    hg_down: str = "ave_pool"
    hourglass_dim: int = 256
    mlp_norm: str = "group"
    mlp_dim_lr: List[int] = _f([321, 1024, 512, 256, 128, 1])
    mlp_dim_hr: List[int] = _f([322, 1024, 512, 256, 128, 1])
    mlp_dim_color: List[int] = _f([513, 1024, 512, 256, 128, 3])
    mlp_res_layers_lr: List[int] = _f([2, 3, 4])
    mlp_res_layers_hr: List[int] = _f([2, 3, 4])
    use_tanh: bool = False

    # ---- Train extras ----
    scale_pifu: float = 0.01
    random_flip: bool = False
    random_trans: bool = False
    random_scale: bool = False
    no_residual: bool = False
    schedule: List[int] = _f([60, 80])
    n_block: List[int] = _f([2, 2, 2])
    gamma: float = 0.1
    color_loss_type: str = "l1"
    losses: str = "l1"
    residual: bool = False
    mlp1: float = 1.0
    mlp2: float = 1.0
    srweight: float = 1.0
    dispweight: float = 1.0
    b_min: List[float] = _f([-128.0, -28.0, -128.0])
    b_max: List[float] = _f([128.0, 228.0, 128.0])
    disp_error: int = 1
    n_train: int = 300
    n_val: int = 60
    optimizer: str = "ADAM"
    momentum: float = 0.9
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8
    ams: bool = False
    weight_decay: float = 0.0

    # ---- Eval ----
    val_test_error: bool = False
    val_train_error: bool = False
    gen_test_mesh: bool = False
    gen_train_mesh: bool = False
    all_mesh: bool = False
    num_gen_mesh_test: int = 1
    n_colors: int = 3
    checkpoints_path: str = "./checkpoints"
    load_netG_checkpoint_path: Optional[str] = None
    load_netC_checkpoint_path: Optional[str] = None
    results_path: str = "./results"
    load_checkpoint_path: Optional[str] = None
    single: str = ""
    mask_path: Optional[str] = None
    img_path: Optional[str] = None
    num_samples: int = 50000
    threshold: float = 0.05
    with_color: bool = False
    both_color: bool = False
    change_weights: bool = False

    # ---- Augmentation ----
    aug_alstd: float = 0.0
    aug_bri: float = 0.0
    aug_con: float = 0.0
    aug_sat: float = 0.0
    aug_hue: float = 0.0
    aug_blur: float = 0.0

    # ---- Performance knobs ('auto' resolves per device, see AUTO) ----
    dtype: str = "auto"
    feature_dtype: str = "auto"
    mesh_axis_data: str = "data"
    mesh_axis_points: str = "points"
    use_pallas: bool = True
    fused_train: bool = False
    remat: bool = False
    remat_encoder: bool = False
    pack_h2d: bool = True
    mask_prune: bool = True
    feature_pack: bool = True
    mc_backend: str = "auto"
    mc_algorithm: str = "auto"
    octree_mode: str = "auto"
    serve_octree_mode: str = "auto"
    octree_init_resolution: int = 64
    use_octree: bool = True
    profile_dir: Optional[str] = None
    seed: int = 1991

    def validate(self) -> "SuRSConfig":
        if self.optimizer not in ("SGD", "ADAM", "RMSprop", "AMSgrad"):
            raise ValueError(f"unknown optimizer {self.optimizer!r}")
        if self.norm not in ("batch", "group"):
            raise ValueError(f"unknown norm {self.norm!r}")
        if self.loadSize % 8 != 0:
            raise ValueError("loadSize must be divisible by 8")
        if len(self.mlp_dim_lr) < 2 or len(self.mlp_dim_hr) < 2:
            raise ValueError("mlp dims need at least two entries")
        return self


_BOOL_FIELDS = {
    f.name for f in dataclasses.fields(SuRSConfig) if f.type == "bool"
}

# The port's 'auto' table. Both devices run the same code: the mono
# octree semantics (recon/evaluator.py) and classic marching cubes on
# whatever device the field lives on (recon/marching.py), the JAX
# package's TPU choice of extractor; only the precision differs. The JAX
# CPU row's host marching tetrahedra is mc_backend='host' (its
# mc_algorithm 'tets' the device's marching tetrahedra); 'auto' as a
# backend is the device with a host fallback on a capacity error, and the
# port sets no capacity unless asked (recon/pipeline.py extract_pair). 'hostloop', 'fused' and 'mono' give identical
# fields in the JAX package (tests/test_recon.py:245,620), so all three
# name the port's one point octree evaluator; 'runs' (the window
# evaluator, recon/evaluator_runs.py) is opt-in, as in the JAX package.
AUTO = {
    "cuda": {"dtype": "bfloat16", "feature_dtype": "bfloat16",
             "octree_mode": "mono", "serve_octree_mode": "mono",
             "mc_backend": "device", "mc_algorithm": "cubes"},
    "cpu": {"dtype": "float32", "feature_dtype": "float32",
            "octree_mode": "mono", "serve_octree_mode": "mono",
            "mc_backend": "device", "mc_algorithm": "cubes"},
}

_PORTED = {
    "dtype": ("float32", "bfloat16"),
    "feature_dtype": ("float32", "bfloat16"),
    "octree_mode": ("hostloop", "fused", "mono", "runs"),
    "serve_octree_mode": ("hostloop", "fused", "mono", "runs"),
    "mc_backend": ("device", "host", "auto", "sharded"),
    "mc_algorithm": ("cubes", "tets"),
}


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another one. Raises when no device was given and no GPU is present;
    it never continues on the CPU by itself."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the port "
            "on the CPU")
    return torch.device("cuda")


def resolve_config(cfg: SuRSConfig, device) -> SuRSConfig:
    """Return ``cfg`` with every 'auto' knob pinned for ``device``; raise
    ``ValueError`` for a value no path takes."""
    table = AUTO["cuda" if torch.device(device).type == "cuda" else "cpu"]
    upd = {name: (table[name] if getattr(cfg, name) == "auto"
                  else getattr(cfg, name)) for name in table}
    cfg = dataclasses.replace(cfg, **upd)
    for name, allowed in _PORTED.items():
        if getattr(cfg, name) not in allowed:
            raise ValueError(f"unknown {name} {getattr(cfg, name)!r}")
    return cfg


def build_parser() -> argparse.ArgumentParser:
    """argparse parser exposing every config field as ``--name``
    (booleans are store_true flags, default-True ones also get
    ``--no_<name>``; list fields take nargs='+')."""
    p = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    defaults = SuRSConfig()
    for f in dataclasses.fields(SuRSConfig):
        name = "--" + f.name
        default = getattr(defaults, f.name)
        if f.name in _BOOL_FIELDS:
            p.add_argument(name, action="store_true", default=default)
            if default:
                p.add_argument("--no_" + f.name, dest=f.name,
                               action="store_false")
        elif isinstance(default, list):
            elem = type(default[0]) if default else str
            p.add_argument(name, nargs="+", type=elem, default=default)
        elif default is None:
            p.add_argument(name, type=str, default=None)
        else:
            p.add_argument(name, type=type(default), default=default)
    return p


def config_from_args(args: argparse.Namespace) -> SuRSConfig:
    """The config of a parsed command line; arguments that are not
    config fields (an entry point's own flags) are left out."""
    return SuRSConfig(**{k: v for k, v in vars(args).items()
                         if k in SuRSConfig.__dataclass_fields__}).validate()


def parse_config(argv: Optional[Sequence[str]] = None) -> SuRSConfig:
    """``build_parser`` over ``argv`` (default ``sys.argv[1:]``) -> a
    validated config (``surs_tpu/config.py:343``)."""
    return config_from_args(build_parser().parse_args(argv))


def print_config(cfg: SuRSConfig) -> str:
    """Every field, sorted, with its default beside it where it differs:
    the reference's option dump (``surs_tpu/config.py:348``)."""
    defaults = SuRSConfig()
    lines = ["----------------- Options ---------------"]
    for f in sorted(dataclasses.fields(SuRSConfig), key=lambda f: f.name):
        v = getattr(cfg, f.name)
        comment = ""
        if v != getattr(defaults, f.name):
            comment = f"\t[default: {getattr(defaults, f.name)}]"
        lines.append(f"{f.name:>25}: {str(v):<30}{comment}")
    lines.append("----------------- End -------------------")
    return "\n".join(lines)
