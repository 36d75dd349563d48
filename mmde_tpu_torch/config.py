"""Typed configuration (dataclasses + YAML loader).

The port's own copy of mmde_tpu/config.py: the same dataclasses, defaults
and YAML schema, so every configs/*.yaml loads to equal contents through
either package (a test holds the two together). Fields that steer
JAX-only machinery (remat policy, scanned blocks, window residency, the
mesh) are kept so configs round-trip; the port says where it ignores them.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

import yaml


@dataclass(frozen=True)
class SwinConfig:
    """SwinTransformerV2 backbone hyperparameters (config.yaml SWIN block)."""
    pretrained: str = ""
    use_checkpoint: bool = False            # gradient checkpointing per stage
    # remat policy when use_checkpoint: "full" | "attn_out" | "attn_qkv" |
    # "mlp_only" | "none". Training-path memory policy; the serving path
    # validates the value and ignores it.
    remat_policy: str = "full"
    depths: Tuple[int, ...] = (2, 2, 18, 2)
    window_size: Tuple[int, ...] = (30, 30, 30, 15)
    pretrain_window_size: Tuple[int, ...] = (12, 12, 12, 6)
    use_shift: Tuple[bool, ...] = (True, True, False, False)
    shift_window_test: bool = False
    shift_size: int = 2
    drop_path_rate: float = 0.3
    # Stages to freeze (reference swin_transformer_v2.py:1201-1216):
    # >=0 freezes patch_embed, >=1 the absolute pos embed, >=i+2 stage i.
    # Gradients are stopped in the module AND the optimizer zeroes both the
    # Adam update and the weight decay for the frozen subtrees.
    frozen_stages: int = -1
    # JAX-package graph-size device (identical blocks compiled as one scan
    # body). PyTorch runs eagerly: accepted and ignored.
    scan_blocks: bool = False
    # Max padded-token fraction at which the JAX package keeps a stage
    # window-resident instead of padding per block. Same values at real
    # token positions either way; the port runs the per-block map path for
    # every stage and ignores this.
    resident_pad_max: float = 0.15


@dataclass(frozen=True)
class CnnTransformerConfig:
    cnn_model: str = "resnet50"             # "resnet18" | "resnet50"
    transformer_ff_dim: int = 4096


@dataclass(frozen=True)
class ModelConfig:
    backbone: str = "cnn_transformer_multi_scale"
    decoder: str = "decoder_v1"             # "decoder_v1" | "decoder_v2"
    model_scale: int = 16                   # 16 | 32
    max_depth: float = 10.0
    # model family: "two_frame" (IDEDepth equivalent), "glpdepth_scale16"
    # (fused out_p custom network), "glpdepth" (legacy single-frame)
    family: str = "two_frame"
    # sparse-depth fusion (depth completion): feed sparse depth + validity
    # as extra input channels (VOID downscale16 depth-completion path)
    sparse_depth_input: bool = False
    swin: SwinConfig = field(default_factory=SwinConfig)
    cnn: CnnTransformerConfig = field(default_factory=CnnTransformerConfig)
    # numerics
    dtype: str = "float32"                  # activation dtype: float32|bfloat16
    use_pallas_attention: bool = True       # fused window attention kernel
    # Attention implementation override: "" derives from
    # use_pallas_attention (True -> the CUDA kernel, False -> plain torch).
    # "cuda" | "torch"; the JAX package's names "pallas" | "xla" are
    # accepted as their counterparts.
    attn_impl: str = ""


@dataclass(frozen=True)
class DataConfig:
    dataset: str = "void"                   # void | nyudepthv2 | kitti | ...
    data_path: str = ""
    # VOID metadata (split lists + calibration.json). Empty -> <data_path>/meta
    # (tools/make_void_lists.py generates the lists from the release layout)
    void_meta_dir: str = ""
    crop_h: int = 480
    crop_w: int = 480
    image_interval_range: Tuple[int, int] = (5, 5)
    workers: int = 8
    imu_max_len: int = 256                  # static pad length for IMU batches
    # eval crops
    do_kb_crop: bool = True
    kitti_crop: Optional[str] = None        # garg_crop | eigen_crop | None
    # ship RGB batches as uint8 and normalize on device (u8/255 matches
    # the host float path to <= 1 ulp): 4x fewer image host->device bytes.
    # YAML key SHIP_UINT8 (extension; not in the reference schema).
    ship_uint8: bool = False


@dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 4
    epochs: int = 25
    max_lr: float = 5e-4
    min_lr: float = 3e-5
    weight_decay: float = 0.05
    layer_decay: float = 0.9
    loss_lambda1: float = 100.0             # rotation weight
    loss_lambda2: float = 100.0             # translation weight
    silog_lambda: float = 0.5
    val_freq: int = 1
    save_freq: int = 1
    print_freq: int = 1
    resume_from: str = ""
    save_model: bool = True
    seed: int = 0


@dataclass(frozen=True)
class EvalConfig:
    max_depth_eval: float = 10.0
    min_depth_eval: float = 1e-4
    flip_test: bool = False
    shift_window_test: bool = False
    save_eval_pngs: bool = False
    save_visualize: bool = False


@dataclass(frozen=True)
class MeshConfig:
    """Data-parallel layout (kept for config parity; multi-card training is
    not ported yet)."""
    data_axis: str = "data"
    num_devices: int = 0                    # 0 => all available


@dataclass(frozen=True)
class Config:
    user_name: str = "mmde"
    log_dir: str = "logs"
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)


def _tup(x) -> Tuple:
    return tuple(x) if isinstance(x, (list, tuple)) else x


def from_yaml_dict(y: dict) -> Config:
    """Build a Config from the reference YAML schema (configs/config.yaml)."""
    swin_y = y.get("SWIN", {})
    cnn_y = y.get("CNN_TRANSFORMER", {})
    swin = SwinConfig(
        pretrained=swin_y.get("PRETRAINED_SWIN", ""),
        use_checkpoint=bool(swin_y.get("USE_CHECKPOINT_SWIN", False)),
        depths=_tup(swin_y.get("DEPTHS", (2, 2, 18, 2))),
        window_size=_tup(swin_y.get("WINDOW_SIZE", (30, 30, 30, 15))),
        pretrain_window_size=_tup(swin_y.get("PRETRAIN_WINDOW_SIZE", (12, 12, 12, 6))),
        use_shift=_tup(swin_y.get("USE_SHIFT", (True, True, False, False))),
        shift_window_test=bool(swin_y.get("SHIFT_WINDOW_TEST", False)),
        shift_size=int(swin_y.get("SHIFT_SIZE", 2)),
        drop_path_rate=float(swin_y.get("DROP_PATH_RATE", 0.3)),
        # extension keys (not in the reference schema)
        remat_policy=str(swin_y.get("REMAT_POLICY", "full")),
        frozen_stages=int(swin_y.get("FROZEN_STAGES", -1)),
        scan_blocks=bool(swin_y.get("SCAN_BLOCKS", False)),
    )
    cnn = CnnTransformerConfig(
        cnn_model=str(cnn_y.get("CNN_MODEL", "resnet50")),
        transformer_ff_dim=int(cnn_y.get("TRANSFORMER_FF_DIM", 4096)),
    )
    model = ModelConfig(
        backbone=y.get("BACKBONE", "cnn_transformer_multi_scale"),
        decoder=y.get("DECODER", "decoder_v1"),
        model_scale=int(y.get("MODEL_SCALE", 16)),
        max_depth=float(y.get("MAX_DEPTH", 10.0)),
        family=y.get("FAMILY", "two_frame"),
        # VOID depth-completion: feed the sparse depth map + validity mask
        # alongside RGB (reference train_void_with_downscale16.py entry)
        sparse_depth_input=bool(y.get("SPARSE_DEPTH_INPUT", False)),
        # extension keys (not in the reference schema): activation dtype and
        # attention kernel selection
        dtype=str(y.get("DTYPE", "float32")),
        use_pallas_attention=bool(y.get("USE_PALLAS_ATTENTION", True)),
        swin=swin, cnn=cnn,
    )
    data = DataConfig(
        dataset=y.get("DATASET_NAME", "void"),
        data_path=y.get("DATA_PATH", ""),
        void_meta_dir=y.get("VOID_META_DIR", ""),
        crop_h=int(y.get("CROP_HEIGHT", 480)),
        crop_w=int(y.get("CROP_WIDTH", 480)),
        image_interval_range=_tup(y.get("IMAGE_INTERVAL_RANGE", (5, 5))),
        workers=int(y.get("WORKERS", 8)),
        do_kb_crop=bool(y.get("DO_KB_CROP", True)),
        # garg_crop / eigen_crop eval sub-region (legacy argparse
        # `--kitti_crop`, configs/base_options.py; absent from the reference
        # YAML schema — accepted here so KITTI eval is YAML-drivable)
        kitti_crop=y.get("KITTI_CROP", None),
        ship_uint8=bool(y.get("SHIP_UINT8", False)),
    )
    train = TrainConfig(
        batch_size=int(y.get("BATCH_SIZE", 4)),
        epochs=int(y.get("EPOCH", 25)),
        max_lr=float(y.get("MAX_LEARNING_RATE", 5e-4)),
        min_lr=float(y.get("MIN_LEARNING_RATE", 3e-5)),
        weight_decay=float(y.get("WEIGHT_DECAY", 0.05)),
        layer_decay=float(y.get("LAYER_DECAY", 0.9)),
        loss_lambda1=float(y.get("LOSS_LAMBDA1", 100.0)),
        loss_lambda2=float(y.get("LOSS_LAMBDA2", 100.0)),
        val_freq=int(y.get("VALIDATION_FREQUENCY", 1)),
        save_freq=int(y.get("SAVE_FREQUENCY", 1)),
        print_freq=int(y.get("PRINT_FREQUENCY", 1)),
        resume_from=y.get("RESUME_FROM", "") or "",
        save_model=bool(y.get("SAVE_MODEL", True)),
        seed=int(y.get("SEED", 0)),
    )
    eval_cfg = EvalConfig(
        max_depth_eval=float(y.get("MAX_DEPTH_EVAL", 10.0)),
        min_depth_eval=float(y.get("MIN_DEPTH_EVAL", 1e-4)),
        flip_test=bool(y.get("FLIP_TEST", False)),
        shift_window_test=bool(swin_y.get("SHIFT_WINDOW_TEST", False)),
        save_eval_pngs=bool(y.get("SAVE_EVAL_PNGS", False)),
        save_visualize=bool(y.get("SAVE_VISUALIZE", False)),
    )
    mesh = MeshConfig(num_devices=int(y.get("NUM_DEVICES", 0)))
    return Config(
        user_name=y.get("USER_NAME", "mmde"),
        model=model, data=data, train=train, eval=eval_cfg, mesh=mesh,
    )


def load_yaml(path: str) -> Config:
    with open(path, "r") as f:
        return from_yaml_dict(yaml.safe_load(f))


def replace(cfg, **kw):
    """dataclasses.replace passthrough for ergonomic config edits."""
    return dataclasses.replace(cfg, **kw)
