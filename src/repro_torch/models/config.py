"""Architecture configuration: one frozen dataclass drives the whole zoo
(port of ``repro/models/config.py``; the dtype names map to torch dtypes)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name ("bfloat16", "float32", ...)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dt


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | ssm | hybrid | moe | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    # attention flavour
    qk_norm: bool = False          # qwen3
    qkv_bias: bool = False         # qwen2
    rope_theta: float = 1e4
    # MoE
    n_experts: int = 0
    top_k: int = 2
    capacity_factor: float = 1.25
    moe_dense_residual: bool = False  # arctic: dense MLP in parallel with MoE
    moe_group_size: int = 2048
    # SSM
    ssm_state: int = 0             # mamba2 d_state / mlstm dk
    ssm_conv: int = 4              # mamba2 causal-conv width
    ssm_expand: int = 2            # mamba2 d_inner = expand * d_model
    # block layout: pattern of block types repeated n_super times.
    # types: "attn" (attention+MLP), "moe" (attention+MoE),
    #        "mamba2", "mlstm", "slstm", "shared_attn" (weight-shared)
    block_pattern: Tuple[str, ...] = ("attn",)
    # enc-dec / multimodal
    encoder_layers: int = 0
    frontend: str = "none"         # "patch" (ViT stub) | "audio" (conv stub)
    frontend_len: int = 0          # embedded frames/patches fed by input_specs
    # numerics
    norm_eps: float = 1e-6
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    cache_dtype: str = "bfloat16"   # KV cache; "float8_e4m3fn" for serving
    # impl knobs
    attn_backend: str = "xla"      # xla | pallas | pallas_interpret
    ssm_backend: str = "xla"
    ssm_chunk: int = 128
    scan_algorithm: str = "ladner_fischer"   # inter-chunk scan circuit
    seq_shard_prefill: bool = False          # sequence parallelism (SSM/hybrid)
    remat: bool = True
    # The reference's lax.scan over superblocks; the port always loops over
    # them in Python.  It keeps the field because it picks the layout of
    # the decode states (stacked, or one dict a superblock).
    scan_layers: bool = True
    logits_softcap: float = 0.0

    # ------------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, 256)

    @property
    def head_chunks(self) -> int:
        """Vocab chunks for the chunk-major unembedding (memory-safe CE).

        padded_vocab is a multiple of 256, so 8/16 always divide."""
        if self.padded_vocab >= 131072:
            return 16
        if self.padded_vocab >= 16384:
            return 8
        return 1

    @property
    def n_super(self) -> int:
        assert self.n_layers % len(self.block_pattern) == 0, (
            f"{self.name}: n_layers={self.n_layers} not divisible by "
            f"pattern length {len(self.block_pattern)}"
        )
        return self.n_layers // len(self.block_pattern)

    @property
    def pdtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return torch_dtype(self.compute_dtype)

    @property
    def cache_torch_dtype(self) -> torch.dtype:
        return torch_dtype(self.cache_dtype)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        """Mamba2/mLSTM heads: d_inner split into head_dim-64 heads."""
        if "mlstm" in self.block_pattern or "slstm" in self.block_pattern:
            return self.n_heads
        return self.d_inner // 64

    @property
    def ssm_head_dim(self) -> int:
        if "mlstm" in self.block_pattern or "slstm" in self.block_pattern:
            return self.d_model // self.n_heads
        return 64

    def param_count(self) -> int:
        """Approximate parameter count (embeddings included once)."""
        d, f, v = self.d_model, self.d_ff, self.padded_vocab
        hd = self.hd
        total = v * d * 2  # embed + unembed
        per = {"attn": 0, "moe": 0, "mamba2": 0, "mlstm": 0, "slstm": 0,
               "shared_attn": 0, "attn_nomlp": 0}
        attn_p = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) + (
            self.n_heads * hd
        ) * d
        mlp_p = 3 * d * f
        per["attn"] = attn_p + mlp_p + 2 * d
        per["shared_attn"] = per["attn"]
        moe_p = attn_p + self.n_experts * 3 * d * f + d * self.n_experts + 2 * d
        if self.moe_dense_residual:
            moe_p += mlp_p
        per["moe"] = moe_p
        di = self.d_inner
        per["mamba2"] = d * (2 * di + 2 * self.ssm_state + self.ssm_heads) + di * d + 2 * d
        hq = self.n_heads * self.ssm_head_dim
        per["mlstm"] = d * 3 * hq + hq * d + 2 * self.n_heads * d + 2 * d + mlp_p
        per["slstm"] = 4 * d * d + 4 * d * d + d * d + 2 * d + mlp_p
        shared_seen = False
        total_blocks = 0
        for _ in range(self.n_super):
            for b in self.block_pattern:
                if b == "shared_attn":
                    if not shared_seen:
                        total_blocks += per[b]
                        shared_seen = True
                else:
                    total_blocks += per[b]
        total += total_blocks
        if self.encoder_layers:
            total += self.encoder_layers * per["attn"]
            # cross-attention in decoder blocks
            total += self.n_layers * attn_p
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if not self.n_experts:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        full = self.param_count()
        moe_blocks = sum(
            1 for _ in range(self.n_super) for b in self.block_pattern if b == "moe"
        )
        inactive = moe_blocks * (self.n_experts - self.top_k) * 3 * d * f
        return full - inactive


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One of the four assigned input shapes."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

SHAPES = {s.name: s for s in [TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K]}
