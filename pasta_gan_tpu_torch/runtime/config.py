"""Typed training configuration (counterpart of `pasta_gan_tpu/runtime/config.py`).

The port keeps its own copy of the preset table and the frozen dataclasses:
the same fields and defaults, so a resolved config reads the same in both
packages.  `from_preset("fashion")` is the PASTA-GAN 256 full-body config of
record.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional


@dataclasses.dataclass(frozen=True)
class CfgSpec:
    """One row of the reference's cfg_specs table."""

    ref_gpus: int
    kimg: int
    mb: int  # total batch
    mbstd: int
    fmaps: float
    lrate: float
    gamma: float  # R1 gamma
    ema: float  # ema_kimg
    ramp: Optional[float]
    map: int  # mapping layers


CFG_SPECS = {
    "stylegan2": CfgSpec(8, 25000, 32, 4, 0.5, 0.002, 10, 10, None, 2),
    "paper256": CfgSpec(8, 25000, 64, 8, 0.5, 0.0025, 1, 20, None, 8),
    "paper512": CfgSpec(8, 25000, 64, 8, 1.0, 0.0025, 0.5, 20, None, 8),
    "paper1024": CfgSpec(8, 25000, 32, 4, 1.0, 0.002, 2, 10, None, 8),
    "cifar": CfgSpec(2, 100000, 64, 32, 1.0, 0.0025, 0.01, 500, 0.05, 2),
    # The config of record for PASTA-GAN 256 full-body training.
    "fashion": CfgSpec(8, 8000, 32, 4, 0.5, 0.002, 10, 10, None, 1),
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    img_resolution: int = 256
    img_channels: int = 3
    z_dim: int = 0
    c_dim: int = 512
    w_dim: int = 512
    mapping_layers: int = 1
    channel_base: int = 16384  # fmaps 0.5 * 32768
    channel_max: int = 512
    conv_clamp: Optional[float] = 256.0
    use_noise: bool = True
    style_input_nc: int = 42  # 10 upper patches * 3 + 4 lower patches * 3
    mbstd_group_size: int = 4
    mbstd_num_channels: int = 1
    freeze_layers: int = 0
    remat: bool = False  # rematerialize synthesis blocks during training


@dataclasses.dataclass(frozen=True)
class LossConfig:
    # train.sh flags of record: l1=40, vgg=40, mask=20, contextual=0, pl=0.
    l1_weight: float = 40.0
    vgg_weight: float = 40.0
    mask_weight: float = 20.0
    contextual_weight: float = 0.0
    pl_weight: float = 0.0
    pl_batch_shrink: int = 2
    pl_decay: float = 0.01
    r1_gamma: float = 10.0
    style_mixing_prob: float = 0.9


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 0.002
    beta1: float = 0.0
    beta2: float = 0.99
    eps: float = 1e-8


@dataclasses.dataclass(frozen=True)
class AdaConfig:
    enabled: bool = True
    target: float = 0.6
    interval: int = 4
    kimg: int = 500
    initial_p: float = 0.0
    pipe: str = "bgc"  # blit + geom + color (the reference default augpipe)
    static_margin: Optional[int] = None
    fast_geom: bool = True
    stack_calls: bool = True


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    model: ModelConfig = ModelConfig()
    loss: LossConfig = LossConfig()
    g_opt: OptimizerConfig = OptimizerConfig()
    d_opt: OptimizerConfig = OptimizerConfig()
    ada: AdaConfig = AdaConfig()

    total_kimg: int = 8000
    batch_size: int = 96  # global batch (train.sh --batch 96)
    g_reg_interval: Optional[int] = 4
    d_reg_interval: Optional[int] = 16
    ema_kimg: float = 10.0
    ema_rampup: Optional[float] = None
    w_avg_beta: float = 0.995
    accum_steps: int = 1  # gradient-accumulation microbatches per phase
    kimg_per_tick: float = 4  # fractional in the port, so a short run can see several ticks
    image_snapshot_ticks: int = 50
    network_snapshot_ticks: int = 50
    tryon_grid_n: int = 6
    random_seed: int = 0
    data_workers: int = 3
    # numerical policy
    compute_dtype: str = "float32"  # "bfloat16": bf16 compute over fp32 master weights
    grad_clip_posinf: float = 1e5  # reference nan_to_num scrubbing bounds


def lazy_reg_scaling(opt: OptimizerConfig, reg_interval: Optional[int]) -> OptimizerConfig:
    """Lazy-regularization lr/beta scaling (`training_loop_wo_flow_fullbody.py:336-341`)."""
    if reg_interval is None:
        return opt
    mb_ratio = reg_interval / (reg_interval + 1)
    return dataclasses.replace(
        opt,
        lr=opt.lr * mb_ratio,
        beta1=opt.beta1**mb_ratio,
        beta2=opt.beta2**mb_ratio,
    )


def from_preset(cfg: str = "fashion", batch: Optional[int] = None, img_resolution: int = 256,
                **overrides) -> TrainConfig:
    spec = CFG_SPECS[cfg]
    model = ModelConfig(
        img_resolution=img_resolution,
        channel_base=int(spec.fmaps * 32768),
        mapping_layers=spec.map,
        mbstd_group_size=spec.mbstd,
    )
    opt = OptimizerConfig(lr=spec.lrate)
    tc = TrainConfig(
        model=model,
        loss=LossConfig(r1_gamma=spec.gamma),
        g_opt=opt,
        d_opt=opt,
        total_kimg=spec.kimg,
        batch_size=batch if batch is not None else spec.mb,
        ema_kimg=spec.ema,
        ema_rampup=spec.ramp,
    )
    if overrides:
        tc = replace_nested(tc, **overrides)
    return tc


def replace_nested(cfg, **overrides):
    """dataclasses.replace supporting dotted keys like 'loss.l1_weight'."""
    direct = {k: v for k, v in overrides.items() if "." not in k}
    nested = {}
    for k, v in overrides.items():
        if "." in k:
            head, rest = k.split(".", 1)
            nested.setdefault(head, {})[rest] = v
    for head, sub in nested.items():
        direct[head] = replace_nested(getattr(cfg, head), **sub)
    return dataclasses.replace(cfg, **direct)


def to_json(cfg) -> str:
    """The resolved config as JSON (the reference's training_options.json)."""
    return json.dumps(dataclasses.asdict(cfg), indent=2)


def from_dict(d) -> TrainConfig:
    """Inverse of `dataclasses.asdict` for a TrainConfig."""
    sub = {"model": ModelConfig, "loss": LossConfig, "g_opt": OptimizerConfig, "d_opt": OptimizerConfig,
           "ada": AdaConfig}
    return TrainConfig(**{k: sub[k](**v) if k in sub else v for k, v in d.items()})
