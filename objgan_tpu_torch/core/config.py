"""Typed configuration tree, loadable from reference-style yml files.

A copy of ``objgan_tpu/core/config.py`` for the port, which imports nothing
of the JAX package: the same frozen dataclass tree, key names, type
coercion, validation and ``tiny_test_config``. ``tests/test_torch_data.py``
holds the two copies equal (``dataclasses.asdict`` of the defaults, the
tiny config and every ``cfg/*.yml``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, fields
from typing import Any, Mapping, Tuple


def _merge_into(dc, overrides: Mapping[str, Any]):
    """Recursively apply a (possibly nested) dict of reference-style keys onto
    a dataclass instance, returning a new instance. Unknown keys raise — the
    same behavior as the lineage ``cfg_from_file``'s key check."""
    known = {f.name: f for f in fields(dc)}
    updates = {}
    for key, value in overrides.items():
        if key not in known:
            raise KeyError(
                f"{type(dc).__name__} has no config key {key!r} "
                f"(known: {sorted(known)})"
            )
        current = getattr(dc, key)
        if dataclasses.is_dataclass(current) and isinstance(value, Mapping):
            updates[key] = _merge_into(current, value)
        else:
            f = known[key]
            # yml gives lists; tuples keep the config hashable for jit.
            if isinstance(value, list):
                value = tuple(value)
            # Type coercion + validation (the lineage cfg_from_file raised
            # on type mismatch; dropping that lets e.g. 'LR: 2e-4' — which
            # PyYAML 1.1 parses as the STRING '2e-4' — silently store a str
            # into a float field and crash far away in optimizer math).
            if f.type == "float":
                if not isinstance(value, bool) and \
                        isinstance(value, (int, str)):
                    try:
                        value = float(value)
                    except ValueError:
                        pass  # falls through to the mismatch error below
                if isinstance(value, bool) or not isinstance(value, float):
                    raise ValueError(
                        f"{type(dc).__name__}.{key} expects a float, got "
                        f"{value!r} ({type(value).__name__})")
            elif f.type == "int":
                if isinstance(value, str):
                    try:
                        value = int(value)
                    except ValueError:
                        pass
                if isinstance(value, bool) or not isinstance(value, int):
                    raise ValueError(
                        f"{type(dc).__name__}.{key} expects an int, got "
                        f"{value!r} ({type(value).__name__})")
            elif f.type == "bool" and not isinstance(value, bool):
                raise ValueError(
                    f"{type(dc).__name__}.{key} expects a bool, got "
                    f"{value!r} ({type(value).__name__}) — yml spells "
                    "booleans true/false")
            elif f.type == "str" and not isinstance(value, str):
                raise ValueError(
                    f"{type(dc).__name__}.{key} expects a string, got "
                    f"{value!r} ({type(value).__name__})")
            updates[key] = value
    return dataclasses.replace(dc, **updates)


@dataclass(frozen=True)
class TreeConfig:
    """Image pyramid: BRANCH_NUM scales starting at BASE_SIZE (64->128->256)."""

    BRANCH_NUM: int = 3
    BASE_SIZE: int = 64


@dataclass(frozen=True)
class SmoothConfig:
    """DAMSM loss temperatures (paper eq. 10-12 of AttnGAN, reused by Obj-GAN)."""

    GAMMA1: float = 4.0
    GAMMA2: float = 5.0
    GAMMA3: float = 10.0
    LAMBDA: float = 50.0


@dataclass(frozen=True)
class TrainConfig:
    FLAG: bool = True
    BATCH_SIZE: int = 16
    MAX_EPOCH: int = 120
    SNAPSHOT_INTERVAL: int = 5   # lineage knob: snapshot every N EPOCHS
    # checkpoint/grid cadence in STEPS. 0 = derive: the CLIs convert
    # SNAPSHOT_INTERVAL epochs to steps when the dataset size is known
    # (manifest feeds), else fall back to every 500 steps.
    SNAPSHOT_STEPS: int = 0
    DISCRIMINATOR_LR: float = 2e-4
    GENERATOR_LR: float = 2e-4
    ENCODER_LR: float = 2e-4
    RNN_GRAD_CLIP: float = 0.25
    B_NET_D: bool = True
    NET_E: str = ""
    NET_G: str = ""
    # K train steps per device execution (lax.scan): amortizes host dispatch
    # latency; metrics/logging granularity becomes K steps.
    STEPS_PER_EXECUTION: int = 1
    SMOOTH: SmoothConfig = field(default_factory=SmoothConfig)


@dataclass(frozen=True)
class GanConfig:
    DF_DIM: int = 64          # discriminator base width
    GF_DIM: int = 32          # generator base width (AttnGAN lineage: 32/48)
    Z_DIM: int = 100          # noise dim
    CONDITION_DIM: int = 100  # CA-net output dim
    R_NUM: int = 2            # residual blocks per NEXT_STAGE
    B_ATTENTION: bool = True
    B_DCGAN: bool = False
    UP_MODE: str = "nearest"  # "nearest" (lineage) | "subpixel" (less HBM)
    # "stages": rematerialize G attention stages + every D/encoder forward
    # in the train step. Measured on v5e at BOTH default dims (+31%
    # ms/step) and 4x width (+29%): XLA fusion already avoids
    # materializing what remat refuses to store, so remat adds flops AND
    # bytes (BASELINE.md round-3 remat tables). Keep "none" unless the
    # config runs out of HBM — this switch is an OOM escape hatch, not a
    # performance tool.
    REMAT: str = "none"       # "none" | "stages"
    # Discriminator/object-D compute dtype: "compute" (follow cfg.DTYPE,
    # i.e. bfloat16 by default) or "float32" (rounds 1-3 behavior). Default
    # flipped to "compute" after the round-4 hardware A/B + quality confirm
    # (BASELINE.md round 4): -7.4% step time / +8.0% train throughput on a
    # step measured AT the HBM roofline, with a 7,200-step confirm curve
    # whose FID/R-precision plateau (0.299/0.552) matches fp32-D
    # (0.296/0.556) point-for-point from step 3600 on. D logits/losses
    # still reduce in fp32; fp32 attention maps unaffected.
    D_DTYPE: str = "compute"  # "compute" | "float32"
    # Dtype of the attention CONTEXT contractions in the generator's
    # attention stages (grid context, object-context paste): "float32"
    # (rounds 1-4 behavior — contexts materialize in fp32 before the cast
    # back to compute dtype) or "compute" (contexts contract in cfg.DTYPE,
    # halving their HBM bytes at 128/256px). The fp32 attention MAPS
    # invariant (BASELINE.json "bitwise-comparable attention maps") is
    # about the softmaxed maps, which stay fp32 either way — this knob
    # only moves the map->context matmul. Round-5 A/B target: the 256px
    # attention stage is 73% of sampling at 638/819 GB/s (VERDICT r4 #2).
    OBJ_PASTE_DTYPE: str = "float32"  # "float32" | "compute"


@dataclass(frozen=True)
class TextConfig:
    CAPTIONS_PER_IMAGE: int = 5
    EMBEDDING_DIM: int = 256  # text feature dim D
    WORDS_NUM: int = 20       # max caption length T (padded/truncated)
    VOCAB_SIZE: int = 27297   # COCO vocab of the lineage pipeline; overridable
    RNN_TYPE: str = "LSTM"
    HIDDEN_DIM: int = 128     # per-direction bi-LSTM hidden (2*128 == EMBEDDING_DIM)
    GLOVE_DIM: int = 300
    # explicit path to a glove.6B.<dim>d.txt-style file; when empty,
    # DATA_DIR/glove.6B.<dim>d.txt is discovered if present (data/glove.py)
    GLOVE_PATH: str = ""
    # DAMSM image backbone: "lite" (InceptionLite, trainable from scratch)
    # or "inception" (full Inception-v3, frozen; load torchvision weights
    # via models/inception_v3.load_torchvision_checkpoint for parity)
    CNN_BACKBONE: str = "lite"
    # training-time probability of replacing a caption token with <unk>, so
    # the <unk> embedding receives gradient signal and novel-word captions
    # at sampling time behave sanely (VERDICT r2 missing #5). Applied only
    # under augment=True feeds and only when the vocab carries <unk>.
    WORD_DROPOUT: float = 0.02


@dataclass(frozen=True)
class ObjConfig:
    """Object/layout parameters — Obj-GAN additions over AttnGAN.

    Everything object-shaped is statically padded to MAX_OBJECTS with a
    validity mask, because XLA wants static shapes (SURVEY.md §7 hard part #1).
    """

    MAX_OBJECTS: int = 10
    NUM_CLASSES: int = 81       # 80 COCO thing classes + background/STOP
    ROI_SIZE: int = 7           # ROI-align output resolution (Fast R-CNN standard)
    LABEL_DIM: int = 300        # GloVe label embedding dim
    GMM_COMPONENTS: int = 20    # mixture components for the box distribution
    # box-mixture covariance (ops/gmm.py module doc):
    # "corr" (default): sketch-RNN-style correlated (x,y)/(w,h) bivariate
    # blocks — won the round-3 held-out ablation on the 2k procedural
    # manifest (NLL -3.19 vs -2.83 diag, sample label-TV 0.057 vs 0.127;
    # BASELINE.md round-3 GMM table). "diag": independent 4-D components.
    GMM_MODE: str = "corr"
    SHAPE_SIZE: int = 64        # per-object mask resolution from stage B


@dataclass(frozen=True)
class BoxGenConfig:
    """Stage A (box_generation) hyper-parameters (argparse ``opts.py`` lineage)."""

    RNN_SIZE: int = 1024
    INPUT_ENCODING_SIZE: int = 300   # GloVe word vectors
    ATT_HID_SIZE: int = 512
    MAX_SEQ_LENGTH: int = 10         # max generated objects
    BEAM_SIZE: int = 1
    # GNMT length-normalization exponent for beam ranking: scores divide by
    # ((5+n)/6)^alpha. Raw-sum ranking (alpha=0) systematically favors short
    # layouts because dead beams emit STOP at zero cost while live beams
    # keep paying <=0 per step (VERDICT r2 weak #3); 0.7 is the GNMT
    # default. box_eval.layout_stats --eval compares beam vs temperature.
    BEAM_LENGTH_NORM: float = 0.7
    TEMPERATURE: float = 0.4         # sampling temperature for labels
    GMM_TEMPERATURE: float = 0.4     # temperature for box mixture sampling
    SCHEDULED_SAMPLING_PROB: float = 0.0
    LEARNING_RATE: float = 5e-4
    GRAD_CLIP: float = 0.1


@dataclass(frozen=True)
class ShapeGenConfig:
    """Stage B (shape_generation) hyper-parameters."""

    GF_DIM: int = 64
    DF_DIM: int = 64
    HIDDEN_DIM: int = 128           # conv-LSTM channels
    LAMBDA_PERCEPTUAL: float = 10.0
    LAMBDA_FM: float = 10.0         # feature-matching weight (perceptual proxy)
    LEARNING_RATE: float = 2e-4
    # perceptual term: "fm" (D-feature-matching substitute, default) or
    # "vgg" (lineage-exact VGG-16 features — models/vgg.py; point
    # VGG_WEIGHTS at a torchvision vgg16 .pth for pretrained features)
    PERCEPTUAL: str = "fm"
    VGG_WEIGHTS: str = ""


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout. Only the data axis is used for parity (SURVEY §2.5);
    the model axis exists as the documented escape hatch for TP."""

    DATA_AXIS: str = "data"
    MODEL_AXIS: str = "model"
    MODEL_PARALLELISM: int = 1


@dataclass(frozen=True)
class Config:
    CONFIG_NAME: str = "objgan"
    DATA_DIR: str = "data/coco"
    OUTPUT_DIR: str = "output"
    GPU_ID: int = 0              # accepted for yml compatibility; unused on TPU
    CUDA: bool = False           # accepted for yml compatibility; unused on TPU
    WORKERS: int = 4
    RNG_SEED: int = 100
    B_VALIDATION: bool = False
    DTYPE: str = "bfloat16"      # compute dtype; params/attn maps stay fp32
    TREE: TreeConfig = field(default_factory=TreeConfig)
    TRAIN: TrainConfig = field(default_factory=TrainConfig)
    GAN: GanConfig = field(default_factory=GanConfig)
    TEXT: TextConfig = field(default_factory=TextConfig)
    OBJ: ObjConfig = field(default_factory=ObjConfig)
    BOX: BoxGenConfig = field(default_factory=BoxGenConfig)
    SHAPE: ShapeGenConfig = field(default_factory=ShapeGenConfig)
    MESH: MeshConfig = field(default_factory=MeshConfig)

    # -- derived helpers ---------------------------------------------------
    @property
    def branch_sizes(self) -> Tuple[int, ...]:
        return tuple(
            self.TREE.BASE_SIZE * (2**i) for i in range(self.TREE.BRANCH_NUM)
        )

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def merged(self, overrides: Mapping[str, Any]) -> "Config":
        return validate_config(_merge_into(self, overrides))


def validate_config(cfg: "Config") -> "Config":
    """Reject configurations this framework cannot honor, at load time.

    Two classes: enum-string fields whose dispatch is ``== "value"`` (a typo
    would otherwise silently select the else-branch), and lineage
    compatibility flags that are ACCEPTED at their reference defaults but
    whose alternate behavior was never built (requesting it must fail loud,
    not train a silently different model). Purely-ignored knobs (GPU_ID,
    CUDA, WORKERS, TRAIN.B_NET_D — D construction follows TRAIN.FLAG here)
    stay unvalidated for yml compatibility.
    """
    checks = [
        (cfg.DTYPE in ("bfloat16", "float32"),
         f"DTYPE must be 'bfloat16' or 'float32', got {cfg.DTYPE!r}"),
        (cfg.GAN.D_DTYPE in ("float32", "compute"),
         f"GAN.D_DTYPE must be 'float32' or 'compute', got {cfg.GAN.D_DTYPE!r}"),
        (cfg.GAN.OBJ_PASTE_DTYPE in ("float32", "compute"),
         f"GAN.OBJ_PASTE_DTYPE must be 'float32' or 'compute', "
         f"got {cfg.GAN.OBJ_PASTE_DTYPE!r}"),
        (cfg.GAN.UP_MODE in ("nearest", "subpixel"),
         f"GAN.UP_MODE must be 'nearest' or 'subpixel', got {cfg.GAN.UP_MODE!r}"),
        (cfg.GAN.REMAT in ("none", "stages"),
         f"GAN.REMAT must be 'none' or 'stages', got {cfg.GAN.REMAT!r}"),
        (cfg.TEXT.RNN_TYPE == "LSTM",
         f"TEXT.RNN_TYPE: only 'LSTM' is implemented (lineage default); "
         f"got {cfg.TEXT.RNN_TYPE!r}"),
        (cfg.GAN.B_ATTENTION,
         "GAN.B_ATTENTION=False (attention-free generator) is not built — "
         "the attention path IS this model"),
        (not cfg.GAN.B_DCGAN,
         "GAN.B_DCGAN=True (single-stage DCGAN topology) is not built"),
        (cfg.MESH.MODEL_PARALLELISM >= 1,
         f"MESH.MODEL_PARALLELISM must be >= 1, got "
         f"{cfg.MESH.MODEL_PARALLELISM} (make_mesh would die in modulo/"
         f"reshape instead of a clear error)"),
    ]
    for ok, msg in checks:
        if not ok:
            raise ValueError(msg)
    return cfg


def cfg_from_file(path: str, base: Config | None = None) -> Config:
    """Load a reference-style yml config and merge it over defaults.

    Mirrors the lineage ``miscc/config.py:cfg_from_file`` contract (same key
    names, unknown keys rejected) but returns an immutable typed tree instead
    of mutating a global.
    """
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    return (base or Config()).merged(raw)


def cfg_from_dict(overrides: Mapping[str, Any], base: Config | None = None) -> Config:
    return (base or Config()).merged(overrides)


def tiny_test_config() -> Config:
    """A miniature config for unit tests: same topology, tiny dims."""
    return Config().merged(
        {
            "TREE": {"BASE_SIZE": 16},  # 16/32/64 pyramid: fast CPU compiles
            "TRAIN": {"BATCH_SIZE": 2},
            "GAN": {"DF_DIM": 8, "GF_DIM": 8, "Z_DIM": 16, "CONDITION_DIM": 16},
            "TEXT": {
                "EMBEDDING_DIM": 32,
                "WORDS_NUM": 6,
                "VOCAB_SIZE": 50,
                "HIDDEN_DIM": 16,
                "GLOVE_DIM": 16,
            },
            "OBJ": {
                "MAX_OBJECTS": 3,
                "NUM_CLASSES": 7,
                "ROI_SIZE": 4,
                "LABEL_DIM": 16,
                "GMM_COMPONENTS": 4,
                "SHAPE_SIZE": 16,
            },
            "BOX": {
                "RNN_SIZE": 32,
                "INPUT_ENCODING_SIZE": 16,
                "ATT_HID_SIZE": 16,
                "MAX_SEQ_LENGTH": 4,
            },
            "SHAPE": {"GF_DIM": 8, "DF_DIM": 8, "HIDDEN_DIM": 8},
        }
    )
