"""Hierarchical run configuration (the port's own copy of
``vlsfr_tpu/config.py``: same dataclass tree, overrides and typed-JSON
loader, so a config file or ``--set`` line means the same to both packages).

Replaces the reference's two-tier config (argparse flags in main.py:150-167 +
typed-JSON optimizer file loaded by util/config.py:37-43) with a single
dataclass tree. Every run is fully described by one Config; any leaf is
overridable from the CLI as ``section.key=value``.

A compatibility loader for the reference's typed-JSON format
(``{"key": ["type", value]}``, see the reference's config/optim_config:1-14)
is provided so existing optimizer configs keep working.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any


# ---------------------------------------------------------------------------
# Typed-JSON compatibility loader (reference util/config.py:4-43)
# ---------------------------------------------------------------------------

_TYPES = {
    "str": str,
    "int": int,
    "bool": bool,
    "float": float,
    "none": lambda x: None,
}


def convert_param(original: list) -> Any:
    """Coerce a ``["type", value-or-list]`` entry to a Python value.

    Mirrors the semantics of reference util/config.py:4-32: scalars and lists
    are supported; ``bool`` accepts "True"/"False" strings; "none" maps to None.
    """
    if not isinstance(original, (list, tuple)) or len(original) != 2:
        raise ValueError(f"typed-json entry must be [type, value], got {original!r}")
    typename, value = original
    if typename not in _TYPES:
        raise ValueError(f"unknown type {typename!r} in typed-json config")
    conv = _TYPES[typename]

    def one(v):
        if typename == "bool" and isinstance(v, str):
            return v == "True"
        return conv(v)

    if isinstance(value, (list, tuple)):
        return [one(v) for v in value]
    return one(value)


def load_typed_json(path: str) -> dict:
    """Load a reference-style typed-JSON config file into a plain dict."""
    with open(path) as f:
        raw = json.load(f)
    return {k: convert_param(v) for k, v in raw.items()}


# ---------------------------------------------------------------------------
# Dataclass config tree
# ---------------------------------------------------------------------------


@dataclass
class ModelConfig:
    """Backbone settings (reference --net_type/--feat_dim, main.py:152,163)."""

    net_type: str = "r50"  # one of models.NET_REGISTRY: mobile | ir18/34/50/100/200 | r18/34/50/101
    feat_dim: int = 512
    image_size: int = 0  # 0 = backbone's native size (112 or 224)
    dropout: float = 0.0
    # Compute dtype for conv/matmul activations. Params always live in fp32;
    # bf16 compute replaces the reference's fp16 AMP (main.py:64,133) — no
    # loss scaling is needed for bf16 on TPU.
    dtype: str = "bfloat16"
    # BN training statistics from a strided subset of the batch rows
    # (0 = full batch). Perf flag: the stem stat-reduces are ~11% of the
    # step; 112^2 spatial positions keep subset estimates tight
    # (models/layers.py _SubsetBN).
    bn_stats_rows: int = 0


@dataclass
class LossConfig:
    """Margin-softmax settings (reference ffc.py:34-48, main.py:158-161)."""

    loss_type: str = "Arc"  # Arc | AM | SV
    margin: float = 0.5
    scale: float = 32.0
    # dead flag, kept for CLI parity: the reference parses --neg_margin
    # (main.py:161) and stores it (ffc.py:44) but never reads it; this
    # framework likewise accepts and ignores it.
    neg_margin: float = 0.25
    mask_svfc: float = 1.2  # SVFC hard-example slope (ffc.py:47)


@dataclass
class PoolConfig:
    """Dynamic Class Pool / FFC settings (reference ffc.py:29-48)."""

    queue_size: int = 1000
    # DCP storage dtype; bfloat16 halves pool HBM traffic at large queue
    # sizes (embeddings are unit-norm, bf16 cosine error ~1e-2). int8
    # (fused head only) stores rows with a per-row scale (ops/qqueue.py):
    # 4x less queue DMA than f32, ~2x the identities per chip, expected
    # row-cosine drift ~4e-5 — rows are replaced whole on admission so the
    # rounding never compounds.
    queue_dtype: str = "float32"  # float32 | bfloat16 | int8
    # int8 queues only: quantize the probe embeddings per-row too and run
    # the fused head's streamed cos dots int8xint8->int32 on the MXU (2x
    # dot throughput on v5e — the head is COMPUTE-bound at >=4M slots,
    # docs/PERF.md round 3). Target columns, written-slot overrides and
    # gt stay exact f32. TPU Pallas path only; covers both the
    # single-shard quad route and the model-sharded quad composition
    # (each shard quantizes its local probe rows — per-row quantization
    # is shard-independent, so the sharded mode matches single-shard).
    queue_int8_compute: bool = False
    # fused-head queue stream tile width (class-axis columns per grid
    # step). 0 = auto: request wide (2048) when the queue size divides
    # 1024, else 512; the kernels then clamp to the itemsize-aware VMEM
    # budget (ops/twin_margin._twin_tile — f32 lands on 1024; int8 at
    # b<=128 takes the measured-calibration cap 2048, docs/PERF.md
    # round-5 floor tool: −9.2 ms head fwd+bwd vs the estimator's 1280)
    # and to the largest dividing 128-multiple (_fit_tile), so an
    # oversized request degrades loudly via the make_ffc_loss_fn warning
    # rather than padding.
    queue_tile: int = 0
    momentum: float = 0.99  # EMA alpha for gallery net (--alpha, main.py:157)
    # hard_neg = clamp(int(queue_size*2e-4), 3, 10) as in ffc.py:48; -1 = auto
    hard_neg: int = -1
    # "full_softmax" disables the DCP and trains a dense classifier over
    # num_classes (BASELINE config 1-2); "ffc" uses the LRU pool.
    head: str = "ffc"  # ffc | full_softmax
    num_classes: int = 0  # required for full_softmax; informational for ffc
    # streaming fused margin-softmax kernel (ops/margin_pallas.py):
    # "auto" switches it on once the class axis reaches streaming_threshold
    use_fused: str = "auto"  # auto | on | off
    streaming_threshold: int = 131072
    # route the fused FFC head through the model-sharded composition (the
    # QUAD both-directions-one-pass lift, parallel/sharded_quad.py) even
    # when the mesh model axis is 1 — validates/benches the multi-chip
    # path on a single chip
    force_sharded: bool = False
    # partial-FC negative sampling (arXiv 2010.05222) for the full_softmax
    # head: fraction of classes in each step's CE denominator (0 = off).
    # Positives are always included.
    sample_rate: float = 0.0
    # with sampling: update only the sampled classifier rows (gather/scatter
    # SGD+momentum, O(S·D) instead of O(C·D) optimizer traffic). Untouched
    # rows skip decay that step (standard sparse-momentum approximation).
    # With the streaming head (sample_rate=0, use_fused), this instead
    # selects the sparse-d_w backward: grads truncated to the
    # sparse_grad_rate most relevant class tiles (ops/margin_pallas.py).
    # NOTE (measured, docs/PERF.md round-2 addendum): at 1-2M ids prefer
    # classifier_dtype=bfloat16 + dense streaming instead — it beats the
    # sparse backward (2129 vs 1986 img/s at 1M) with an exact-up-to-bf16
    # gradient. sparse_update is the escape hatch for ≥4M-id class axes
    # where even the bf16 dense d_w store dominates the step.
    sparse_update: bool = False
    # fraction of class tiles kept by the sparse streaming backward
    # (targets + top-k tiles are always kept); the loss itself stays exact
    sparse_grad_rate: float = 0.05
    # fuse the classifier's SGD-momentum update into the streaming
    # backward kernel (ops/margin_pallas.streaming_margin_grads_fused_sgd):
    # the dense [C, D] d_w never exists in HBM — it is consumed tile-by-
    # tile in the same pass that computes it, saving the d_w store+load
    # and one classifier read per step (~5.3 GB at C=1M). Exact optax
    # semantics. "auto" = on for the dense streaming head on an unsharded
    # mesh with SGD and no global-norm clipping; ignored elsewhere.
    fused_update: str = "auto"  # auto | on | off
    # classifier (+ bare momentum buffer) storage dtype for the
    # full_softmax head. bfloat16 halves the 4 GB/1M-ids footprint and the
    # streaming forward's HBM read — the single-chip 4M-identity enabler
    # (insightface partial_fc ships fp16 classifiers; rows are
    # re-normalized every forward so only direction matters).
    classifier_dtype: str = "float32"  # float32 | bfloat16
    # momentum-buffer storage dtype, FUSED-update head only (measured
    # 1.32x on the fused head at C=1M — 12.89 -> 9.74 ms — by halving the
    # 4 GB momentum read+write; docs/PERF.md round 3). bf16 momentum
    # rounds the accumulated trace to 8 mantissa bits, so the trajectory
    # is no longer bit-exact vs optax (tests/test_fused_update.py bounds
    # the drift); the sparse head keeps f32 regardless (its visit-age
    # catch-up compounds the rounding geometrically).
    classifier_mom_dtype: str = "float32"  # float32 | bfloat16
    # batch the two probe (and two gallery) passes into one 2B forward —
    # faster on TPU; BN batch stats then span 2B samples (perf mode, not
    # bit-equivalent to the reference's per-pass statistics)
    fuse_forward: bool = False
    # run the gallery (EMA) backbone forward with int8×int8→int32 convs
    # (ops/quant.py: per-channel weights, dynamic per-tensor activations).
    # v5e runs int8 convs 1.5-3.6× faster than bf16 (docs/PERF.md round 3);
    # the gallery needs no gradients, so only embedding drift is at stake
    # (measured within the 0.999 cosine fidelity gate with per-channel
    # scales). Perf flag, default off.
    gallery_int8: bool = False


@dataclass
class OptimConfig:
    """Optimizer + schedule (reference config/optim_config + optim/optimizer.py)."""

    optim: str = "SGD"  # SGD | RMSprop
    lr: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 1e-4
    nesterov: bool = True
    scheduler: str = "multistep"  # cos | multistep | exponential | linear | plateau
    epochs: int = 18
    warmup_epochs: int = 0
    milestones: list[int] = field(default_factory=lambda: [8, 14, 17])
    gammas: list[float] = field(default_factory=lambda: [0.1, 0.1, 0.1])
    gamma: float = 0.9  # exponential
    eta_min: float = 0.0  # cosine
    t_max: int = 0  # cosine; 0 = epochs
    lr_min: float = 1e-5  # linear / plateau
    patience: int = 10  # plateau
    grad_clip: float = 0.0  # 0 = off


@dataclass
class DataConfig:
    """Dataset + input pipeline (reference util/lmdb_loader.py, main.py:102-111)."""

    sources: list[str] = field(default_factory=list)  # record-store dirs
    batch_size: int = 64  # global batch (split across data-parallel shards)
    image_size: int = 112
    prefetch: int = 2  # device prefetch depth (double buffering)
    num_workers: int = 8  # host decode threads
    seed: int = 0
    synthetic: bool = False  # use generated data (tests/benchmarks)
    # hard mode: identities are perturbations of a shared manifold, so
    # verification accuracy measures learned discrimination (synthetic.py)
    synthetic_hard: bool = False
    synthetic_ids: int = 100
    synthetic_images_per_id: int = 10


@dataclass
class MeshConfig:
    """Device mesh layout (new in rebuild; reference is single-GPU)."""

    # number of devices along each axis; -1 on data = use all remaining
    data: int = -1
    model: int = 1  # class-axis sharding (partial-FC) over ICI


@dataclass
class TrainConfig:
    """Training-loop settings (reference main.py:23-143)."""

    saved_dir: str = "checkpoint"
    print_freq: int = 1000  # reference main.py:154 default
    save_freq: int = 1000  # checkpoint cadence (main.py:76)
    keep_checkpoints: int = 5
    pretrained_model_path: str = ""
    resume: bool = True  # auto-resume from latest checkpoint if present
    steps_per_epoch: int = 0  # 0 = derive from dataset size
    log_dir: str = ""  # tensorboard; "" = saved_dir/logs
    eval_freq: int = 0  # steps between in-training verification evals (0 = off)
    eval_records: int = 512  # max records sampled for in-training eval
    eval_pairs: int = 500  # verification pairs per eval
    # reserve the LAST N store records as a held-out eval split (excluded
    # from both training streams); 0 = eval samples from the train set
    # (smoke signal only)
    holdout_records: int = 0
    # insightface-style verification .bin evaluated at eval_freq (lfw.bin…)
    eval_bin: str = ""
    # FFC only: evaluate with the EMA gallery net instead of the probe net.
    # The gallery IS a model EMA (pool.momentum-smoothed copy of the probe,
    # core/ffc.py) — EMA weights typically verify better late in training.
    eval_use_ema: bool = False


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    pool: PoolConfig = field(default_factory=PoolConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    data: DataConfig = field(default_factory=DataConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    # ------------------------------------------------------------------
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        kwargs = {}
        for f in dataclasses.fields(cls):
            sub = d.get(f.name, {})
            sub_cls = f.default_factory  # type: ignore[misc]
            if dataclasses.is_dataclass(sub_cls()):
                valid = {x.name for x in dataclasses.fields(sub_cls())}
                kwargs[f.name] = sub_cls(**{k: v for k, v in sub.items() if k in valid})
        return cls(**kwargs)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)

    @classmethod
    def load(cls, path: str) -> "Config":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    # ------------------------------------------------------------------
    def apply_overrides(self, overrides: list[str]) -> "Config":
        """Apply ``section.key=value`` CLI overrides in place; returns self."""
        for ov in overrides:
            if "=" not in ov:
                raise ValueError(f"override must be section.key=value, got {ov!r}")
            dotted, raw = ov.split("=", 1)
            parts = dotted.split(".")
            if len(parts) != 2:
                raise ValueError(f"override key must be section.key, got {dotted!r}")
            section, key = parts
            if not hasattr(self, section):
                raise ValueError(f"unknown config section {section!r}")
            node = getattr(self, section)
            if not hasattr(node, key):
                raise ValueError(f"unknown config key {section}.{key}")
            cur = getattr(node, key)
            setattr(node, key, _coerce_like(cur, raw))
        return self

    def apply_reference_optim_config(self, path: str) -> "Config":
        """Merge a reference-style typed-JSON optimizer config (compat shim)."""
        d = load_typed_json(path)
        mapping = {
            "optim": "optim",
            "LR": "lr",
            "momentum": "momentum",
            "decay": "weight_decay",
            "nesterov": "nesterov",
            "scheduler": "scheduler",
            "epochs": "epochs",
            "warmup": "warmup_epochs",
            "milestones": "milestones",
            "gammas": "gammas",
            "gamma": "gamma",
            "eta_min": "eta_min",
            "T_max": "t_max",
            "LR_min": "lr_min",
            "patience": "patience",
        }
        for src, dst in mapping.items():
            if src in d:
                setattr(self.optim, dst, d[src])
        if self.optim.scheduler == "ReduceLROnPlateau":
            self.optim.scheduler = "plateau"
        return self


def _coerce_like(current: Any, raw: str) -> Any:
    """Coerce a CLI string to the type of the current config value."""
    if isinstance(current, bool):
        return raw.lower() in ("1", "true", "yes", "on")
    if isinstance(current, int):
        return int(raw)
    if isinstance(current, float):
        return float(raw)
    if isinstance(current, list):
        if raw.strip() == "":
            return []
        items = [x.strip() for x in raw.strip("[]").split(",") if x.strip()]
        elem = current[0] if current else None
        if isinstance(elem, bool):
            return [x.lower() in ("1", "true") for x in items]
        if isinstance(elem, int):
            return [int(x) for x in items]
        if isinstance(elem, float):
            return [float(x) for x in items]
        return items
    return raw
