"""Model / shape configuration dataclasses and the arch registry."""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Callable


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | vlm | audio | hybrid | ssm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads

    # Block pattern: the repeating unit scanned over; leftover layers follow
    # the pattern prefix. Kinds: attn | attn_local | moe | rec | rwkv
    block_pattern: tuple = ("attn",)
    window: int = 0                 # local-attention window (attn_local)

    # MoE
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 1
    moe_d_ff: int = 0               # expert hidden size (0 -> d_ff)
    capacity_factor: float = 1.25
    router_act: str = "softmax"     # softmax | sigmoid (llama4)

    # Positional encoding
    pos_emb: str = "rope"           # rope | mrope | sinusoidal
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0      # stablelm: 0.25
    mrope_sections: tuple = (16, 24, 24)  # qwen2-vl (t, h, w) half-dims

    # Norm / misc
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    qkv_bias: bool = False
    tie_embeddings: bool = False

    # Recurrent families
    conv_width: int = 4             # griffin temporal conv
    rglru_c: float = 8.0

    # Frontend: tokens (LM) | frames (audio stub) | patches (vision stub)
    frontend: str = "tokens"

    dtype: str = "bfloat16"
    q_chunk: int = 256              # blocked-attention query chunk

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def unit_len(self) -> int:
        return len(self.block_pattern)

    @property
    def num_units(self) -> int:
        return self.num_layers // self.unit_len

    @property
    def leftover_pattern(self) -> tuple:
        return self.block_pattern[: self.num_layers % self.unit_len]

    @property
    def is_attention_free(self) -> bool:
        return all(k in ("rwkv", "rec") for k in self.block_pattern)

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic decode: no *global* attention blocks."""
        return all(k in ("rwkv", "rec", "attn_local") for k in self.block_pattern)

    def reduced(self, **overrides) -> "ModelConfig":
        """A smoke-test-sized config of the same family (see tests)."""
        scale = dict(
            num_layers=max(2 * self.unit_len, self.unit_len),
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads < self.num_heads else 4,
            d_ff=128,
            vocab_size=256,
            head_dim=16,
            num_experts=min(self.num_experts, 4),
            num_shared_experts=min(self.num_shared_experts, 1),
            moe_d_ff=64 if self.moe_d_ff else 0,
            window=min(self.window, 16) if self.window else 0,
            mrope_sections=(4, 2, 2),
            dtype="float32",
            q_chunk=16,
        )
        scale.update(overrides)
        return replace(self, **scale)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> ModelConfig:
    import repro_torch.configs  # noqa: F401 — populate registry
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs() -> list[str]:
    import repro_torch.configs  # noqa: F401
    return sorted(_REGISTRY)


def shape_cells(cfg: ModelConfig) -> list[ShapeConfig]:
    """The shape cells this arch runs (long_500k only for sub-quadratic)."""
    cells = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
    if cfg.supports_long_context:
        cells.append(SHAPES["long_500k"])
    return cells
