"""Configuration dataclasses and dataset presets (PyTorch port).

The same typed config tree and presets as ``mclstexp_tpu/config.py``, so a
config written for one package reads the same in the other. Some knobs only
choose a memory layout for the TPU build; the port accepts them so configs
stay interchangeable, and ignores them (each is marked below).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Flagship contrastive model hyper-parameters.

    Defaults mirror the reference protocol: DenseNet121 image tower (1024-d
    features), 785-d spot features (HER2ST HVG panel), 256-d projections,
    2 attention blocks of 8 heads x 64.
    """

    encoder_name: str = "densenet121"
    image_dim: int = 1024  # feature dim emitted by the image tower
    spot_dim: int = 785  # number of HVGs == spot feature dim
    projection_dim: int = 256
    heads_num: int = 8
    heads_dim: int = 64
    head_layers: int = 2
    dropout: float = 0.0
    temperature: float = 1.0
    pos_vocab: int = 65536  # learnable (x, y) table size
    variant: str = "attention"  # "attention" | "mlp" (ablation)
    # Compute dtype for the towers and heads ("float32" or "bfloat16").
    # Parameters are always fp32; bf16 runs the products (and the flash
    # kernels) in bf16; embeddings and the loss are fp32.
    dtype: str = "float32"
    # Spot-attention backend: "xla" runs the plain fp32-softmax path,
    # "flash" the CUDA flash-attention kernels on the card (forward, and the
    # dK/dV and dQ kernels when training; the plain versions on the CPU),
    # "ring" the sequence-parallel ring attention over the "seq" axis of the
    # active mesh (parallel/mesh.active_mesh; it raises without one).
    attn_backend: str = "xla"
    # torch .pt of an ImageNet-pretrained image tower (torchvision/timm
    # state_dict), grafted into the fresh model (models/image/torch_import.py)
    pretrained_path: Optional[str] = None
    # TPU layout knobs, accepted and ignored by the port: rematerialization
    # and the dense-block materialization strategy change memory traffic on
    # the TPU build only (identical parameters and numerics).
    remat_tower: bool = False
    dense_block_impl: str = "piecewise8"


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 128
    max_epochs: int = 90
    lr: float = 1e-4
    weight_decay: float = 1e-3  # torch-Adam style L2 (coupled)
    seed: int = 0
    log_every: int = 50
    checkpoint_every_epochs: int = 10
    checkpoint_dir: str = "model_result"
    donate: bool = True  # buffer donation: a JAX notion, ignored by the port
    # Rotation implementation for train-time augmentation: "paeth" (three
    # shears through the row_shift kernel) or "gather" (direct
    # nearest-neighbour inverse map).
    rot_impl: str = "paeth"
    # The data-parallel mesh (parallel/mesh.train_mesh): None is one "data"
    # axis over every rank of the process group, or no mesh for one process
    # without a group; axes other than "data" must be of length 1.
    mesh_shape: Optional[Tuple[int, ...]] = None
    mesh_axes: Tuple[str, ...] = ("data",)
    debug_nans: bool = False  # JAX NaN sanitizer; ignored by the port
    # A training set of more raw bytes than this is streamed to the device
    # batch by batch (data/pipeline.prefetch_to_device) instead of kept there.
    device_data_budget_bytes: int = 4 * 1024**3


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    batch_size: int = 32  # the spot tower sees each batch as one sequence
    top_k: int = 200
    weight_ord: int = 1  # distance order for 1/d^2 weights: 1 (her2st) or 2
    embedding_dir: str = "embedding_result"
    prediction_dir: str = "prediction_result"


@dataclasses.dataclass(frozen=True)
class DataConfig:
    dataset: str = "her2st"  # her2st | cscc | visium | synthetic
    data_root: str = ""
    gene_panel: str = ""
    preprocessed_root: str = "data/preprocessed_expression_matrices"
    patch_size: int = 224
    num_folds: int = 32
    patch_cache_dir: str = "patch_cache"
    eval_time_augment: bool = False
    pos_remap: bool = False
    visium_raw_scale: bool = False


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    eval: EvalConfig = dataclasses.field(default_factory=EvalConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


# Feature dims of the supported image towers (the JAX package's
# ENCODER_DIMS; the reference's torchvision/timm towers and two test towers).
ENCODER_DIMS = {
    "densenet121": 1024,
    "resnet50": 2048,
    "res101": 2048,
    "res18": 512,
    "vit": 768,  # ViT-B/32, mean-pooled patch tokens
    "resnet152": 2048,
    "vit_l": 1024,  # ViT-L/32
    "clip_vit": 768,  # CLIP ViT-B/32 (pre-norm trunk)
    "tiny_cnn": 128,  # test-sized tower, the synthetic preset's
    "tiny_densenet": 16,  # test-sized densenet code paths
}


def _preset(
    dataset: str,
    spot_dim: int,
    num_folds: int,
    top_k: int,
    weight_ord: int,
    eval_time_augment: bool = False,
    visium_raw_scale: bool = False,
    pos_vocab: int = 65536,
    pos_remap: bool = False,
) -> Config:
    return Config(
        model=ModelConfig(spot_dim=spot_dim, pos_vocab=pos_vocab),
        train=TrainConfig(),
        eval=EvalConfig(top_k=top_k, weight_ord=weight_ord),
        data=DataConfig(
            dataset=dataset,
            num_folds=num_folds,
            eval_time_augment=eval_time_augment,
            visium_raw_scale=visium_raw_scale,
            pos_remap=pos_remap,
        ),
    )


# Protocol constants per dataset:
#   HER2ST: 785 HVGs, 32 LOO folds, K=200, L1 distance weights
#   cSCC:   171 HVGs, 12 folds, K=600, L2
#   Visium: 685 HVGs,  9 folds, K=200, L2, eval-time augmentation quirk
# The ST presets keep 1024-row position tables: ST array coordinates stay
# far below that, so the rows beyond it are never read.
PRESETS = {
    "her2st": _preset("her2st", 785, 32, 200, 1, pos_vocab=1024),
    "cscc": _preset("cscc", 171, 12, 600, 2, pos_vocab=1024),
    "visium": _preset("visium", 685, 9, 200, 2, eval_time_augment=True,
                      visium_raw_scale=True, pos_remap=True),
    "synthetic": Config(
        model=ModelConfig(
            encoder_name="tiny_cnn", image_dim=128, spot_dim=32, projection_dim=32
        ),
        train=TrainConfig(batch_size=32, max_epochs=2),
        eval=EvalConfig(batch_size=16, top_k=8, weight_ord=1),
        data=DataConfig(dataset="synthetic", num_folds=3, patch_size=32),
    ),
}


def get_config(name: str) -> Config:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
    return PRESETS[name]


def her2st_config(checkpoint_dir: str = "model_result") -> Config:
    """The her2st preset at full width for short runs on the card: batch 128,
    one epoch, logging every step, the final checkpoint only."""
    cfg = PRESETS["her2st"]
    return cfg.replace(train=dataclasses.replace(
        cfg.train, batch_size=128, max_epochs=1, log_every=1,
        checkpoint_every_epochs=0, checkpoint_dir=checkpoint_dir, seed=0,
    ))


REFERENCE_DATA_FALLBACK = "/root/reference/data"  # the JAX package's mount point


def reference_data_root() -> Optional[str]:
    """The directory that holds the reference's shipped gene panels:
    ``MCLSTEXP_REFERENCE_DATA`` if it names a directory, else the reference
    checkout's data directory where one is mounted, as in the JAX package;
    None when neither exists."""
    for cand in (os.environ.get("MCLSTEXP_REFERENCE_DATA"), REFERENCE_DATA_FALLBACK):
        if cand and os.path.isdir(cand):
            return cand
    return None
