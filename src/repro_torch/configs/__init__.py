"""Architecture registry of the LM framework, and the paper's field configs.

``ArchConfig`` and ``CompressionConfig`` are the reference's field for field
(names and defaults, and the properties the ported models read:
``vocab_padded``, ``n_experts_padded``, ``resolved_head_dim``, ``d_inner``,
``ssm_nheads``), so one config means the same thing to both packages.
``get_config(name)`` returns an arch's full published config and
``get_smoke_config(name)`` its reduced same-family config, for every arch
of the reference's registry.  The field configurations of the paper's
experiments are in :mod:`.ffcz_fields`.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple

ARCH_IDS = (
    "qwen2-0.5b",
    "qwen2-7b",
    "granite-3-2b",
    "minitron-4b",
    "granite-moe-3b-a800m",
    "llama4-maverick-400b-a17b",
    "mamba2-2.7b",
    "zamba2-7b",
    "llava-next-mistral-7b",
    "whisper-tiny",
)

#: the archs whose config module the port has: all of the reference's
PORTED_ARCH_IDS = ARCH_IDS

#: (seq_len, global_batch, kind) per shape cell
SHAPES = {
    "train_4k": (4_096, 256, "train"),
    "prefill_32k": (32_768, 32, "prefill"),
    "decode_32k": (32_768, 128, "decode"),
    "long_500k": (524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    """FFCz integration knobs."""

    grad_compression: bool = False
    grad_E_rel: float = 1e-2
    grad_Delta_rel: float = 1e-2
    grad_block: int = 4096
    grad_bits: int = 8
    checkpoint_compression: bool = False
    ckpt_E_rel: float = 1e-4
    ckpt_Delta_rel: float = 1e-4
    kv_cache_compression: bool = False
    kv_E_rel: float = 1e-2
    kv_Delta_rel: float = 1e-2


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    qkv_bias: bool = False
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1  # apply MoE every k-th layer (others dense)
    shared_expert: bool = False
    capacity_factor: float = 1.25
    # --- SSM (Mamba2/SSD) ---
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_ngroups: int = 1
    ssm_chunk: int = 256
    conv_kernel: int = 4
    # --- hybrid (Zamba2-style shared attention) ---
    attn_every: int = 0  # >0: weight-shared attention block every k core layers
    # --- encoder-decoder (Whisper) ---
    encoder_layers: int = 0
    encoder_seq: int = 0  # stub frontend sequence length (audio frames)
    # --- VLM stub ---
    vision_tokens: int = 0
    vision_dim: int = 0
    # --- common ---
    pos_type: str = "rope"  # rope | sinusoidal | none
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # --- runtime ---
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    attention_impl: str = "xla_flash"  # xla_flash | pallas | naive
    remat: str = "dots"  # none | dots | full (activation checkpointing under autograd)
    causal_scheduling: bool = True  # skip fully-masked causal kv blocks (perf)
    # mesh axes ((name, size), ...), set by make_step and Trainer(mesh=...):
    # the models' layout hints (no arithmetic; the split compute comes from
    # sharding/tp.py's context)
    mesh_axes: tuple = ()
    shard_attn_activations: bool = True
    compression: CompressionConfig = dataclasses.field(default_factory=CompressionConfig)

    @property
    def vocab_padded(self) -> int:
        """Vocab padded to a multiple of 128; logits of padded ids are masked."""
        return ((self.vocab + 127) // 128) * 128

    @property
    def n_experts_padded(self) -> int:
        """Experts padded to a multiple of 16 (dead experts are never routed:
        the router stays at ``n_experts``)."""
        return ((self.n_experts + 15) // 16) * 16 if self.n_experts else 0

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def supports_long_context(self) -> bool:
        """Sub-quadratic decode state => long_500k is runnable."""
        return self.family in ("ssm", "hybrid")

    def cells(self) -> Tuple[str, ...]:
        """Runnable shape cells of this arch (the dry run's loop)."""
        out = ["train_4k", "prefill_32k", "decode_32k"]
        if self.supports_long_context():
            out.append("long_500k")
        return tuple(out)


_MODULES = {arch: arch.replace("-", "_").replace(".", "_") for arch in ARCH_IDS}


def _module(name: str):
    if name not in _MODULES:
        raise ValueError(f"unknown arch {name!r}; have {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str, **overrides) -> ArchConfig:
    cfg = _module(name).CONFIG
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def get_smoke_config(name: str, **overrides) -> ArchConfig:
    cfg = _module(name).SMOKE
    return dataclasses.replace(cfg, **overrides) if overrides else cfg
