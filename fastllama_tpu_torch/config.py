"""Model / engine configuration.

The port's own copy of ``fastllama_tpu/config.py`` (pure Python, no
framework): quantization types with the reference's factors, the model's
hyper-parameters and the engine knobs.  Field names and defaults match the
JAX package so a configuration reads the same in both.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class QuantType(enum.Enum):
    """Quantization bit-widths."""

    NONE = 0
    INT16 = 1
    INT8 = 2
    INT4 = 3

    @property
    def factor(self) -> int:
        # max|group| / factor is the group scale
        return {QuantType.NONE: 0, QuantType.INT16: 5792,
                QuantType.INT8: 127, QuantType.INT4: 7}[self]

    @staticmethod
    def parse(name: str) -> "QuantType":
        return {
            "none": QuantType.NONE, "fp32": QuantType.NONE,
            "int16": QuantType.INT16, "q16": QuantType.INT16,
            "int8": QuantType.INT8, "q8": QuantType.INT8,
            "int4": QuantType.INT4, "q4": QuantType.INT4,
        }[name.lower()]


class ModelArchitecture(enum.Enum):
    NONE = 0
    LLAMA = 1


class ActivationType(enum.Enum):
    NONE = 0
    SILU = 1
    SWIGLU = 2


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Static transformer hyper-parameters."""

    dim: int
    hidden_dim: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    vocab_size: int
    max_seq_len: int

    arch: ModelArchitecture = ModelArchitecture.LLAMA
    act_type: ActivationType = ActivationType.SWIGLU
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5

    # YaRN / NTK context-extension knobs; rope_orig_ctx 0 = max_seq_len
    rope_freq_scale: float = 1.0
    rope_ext_factor: float = 0.0
    rope_attn_factor: float = 1.0
    rope_beta_fast: float = 32.0
    rope_beta_slow: float = 1.0
    rope_orig_ctx: int = 0

    quant_type: QuantType = QuantType.INT8
    group_size: int = 64

    name: str = ""

    @property
    def head_size(self) -> int:
        return self.dim // self.n_heads

    @property
    def kv_dim(self) -> int:
        return self.head_size * self.n_kv_heads

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    def validate(self) -> None:
        if self.dim % self.n_heads != 0:
            raise ValueError(f"dim={self.dim} not divisible by n_heads={self.n_heads}")
        if self.n_heads % self.n_kv_heads != 0:
            raise ValueError(
                f"n_heads={self.n_heads} not divisible by n_kv_heads={self.n_kv_heads}")

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Runtime engine knobs (same fields as the JAX package's)."""

    max_seq_len: Optional[int] = None
    max_batch_size: int = 1
    prefill_buckets: tuple = (32, 64, 128, 256, 512, 1024)
    prefix_cache: bool = False
    prefill_chunk: int = 0              # single-stream engine only
    kv_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # True: the hand-written kernels on the card (plain versions on the
    # CPU).  False: the plain PyTorch versions on any device — the
    # reference path chip_smoke.py holds the kernels against.
    use_pallas: bool = True
    # False: the always-streaming decode attention (single stream) and the
    # plain per-slot attention (batched), as in the JAX package
    flash_attention: bool = True
    fuse_weights: bool = True
    parity_mode: bool = False
    donate_cache: bool = True           # the port updates the cache in place
    # group-scale storage dtype for non-wide weights; "auto" resolves per
    # engine (resolve_scale_dtype)
    scale_dtype: str = "auto"
    deferred_kv: bool = False
    qos_chunk: int = 0
    # a mesh of ranks, e.g. "model=8" or "data=2,model=4" (empty: one
    # card): every rank keeps its shards and runs the per-rank steps of
    # parallel/spmd_step.py.  spmd_kernels asks for the same path with a
    # mesh (the port has no second, auto-partitioned one) and for nothing
    # without one, as in the JAX package
    mesh: str = ""
    spmd_kernels: bool = False
    pallas_interpret: bool = False      # TPU-only: raises in the port


def resolve_scale_dtype(ec: EngineConfig, config: ModelConfig,
                        batched: bool, pallas_live: Optional[bool] = None
                        ) -> str:
    """Resolve ``EngineConfig.scale_dtype`` — in particular "auto" — to a
    concrete storage dtype, with the JAX package's rule: bf16 scales only
    for single-stream INT8 decode on the kernel path; float32 for the
    batched engines, parity mode and INT16/INT4."""
    if ec.scale_dtype != "auto":
        return ec.scale_dtype
    if pallas_live is None:
        pallas_live = ec.use_pallas
    if (not batched and pallas_live and not ec.parity_mode
            and config.quant_type == QuantType.INT8):
        return "bfloat16"
    return "float32"
