"""Architecture/config schema (a copy of ``repro.configs.base``).

Every architecture file under ``repro_torch/configs`` exports ``CONFIG``
(the exact published configuration); reduced smoke variants are derived
mechanically via :func:`smoke_config`. The fields, defaults and derived
properties are those of the JAX package, so a config built here compares
equal field by field with its JAX counterpart.
"""

from __future__ import annotations

import dataclasses
from dataclasses import replace


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense|moe|vlm|audio|ssm|hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    # Block program: entry = "<mixer>[:<ffn>]", mixer in
    # {attn, attn_local, mamba, mlstm, slstm}, ffn in {dense, moe, none}.
    # Default ffn: "dense" if d_ff > 0 else "none". Cycled over layers.
    block_pattern: tuple = ("attn",)
    # attention
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_kind: str = "rope"          # rope|mrope|sinusoidal|none
    rope_theta: float = 1e4
    sliding_window: int = 1024
    ffn_act: str = "swiglu"          # swiglu|gelu
    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    moe_group_size: int = 1024
    # SSM (Mamba)
    ssm_d_state: int = 16
    ssm_conv_dim: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0             # 0 -> d_model // 16
    ssm_chunk: int = 128
    ssm_fuse: bool = True
    # xLSTM
    xlstm_proj_factor: float = 2.0
    # embeddings / head
    tie_embeddings: bool = False
    embed_inputs: bool = True        # False: inputs are precomputed embeddings
    norm_eps: float = 1e-6
    param_dtype: str = "bfloat16"
    # attention execution
    q_chunk: int = 512
    kv_chunk: int = 1024
    # capability flags
    long_context_ok: bool = False
    # training execution defaults
    remat: str = "full"              # none|full|dots
    decode_unroll: bool = False

    # ---- derived ----
    @property
    def head_dim_eff(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return self.ssm_dt_rank or max(1, self.d_model // 16)

    @property
    def xlstm_d_inner(self) -> int:
        return int(self.xlstm_proj_factor * self.d_model)

    def layer_plan(self) -> tuple:
        """Block descriptor per layer, pattern cycled over n_layers."""
        out = []
        for i in range(self.n_layers):
            ent = self.block_pattern[i % len(self.block_pattern)]
            if ":" not in ent:
                ent = ent + (":dense" if self.d_ff > 0 else ":none")
            out.append(ent)
        return tuple(out)

    def scan_split(self) -> tuple:
        """(n_repeats, unit_len, n_tail) for scan-over-repeated-pattern."""
        u = len(self.block_pattern)
        return self.n_layers // u, u, self.n_layers % u


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train|prefill|decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def shapes_for(cfg: ModelConfig) -> list:
    """The shape cells that apply to this architecture (the JAX
    package's ``shapes_for``)."""
    out = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
    if cfg.long_context_ok:
        out.append(SHAPES["long_500k"])
    return out


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    unit = len(cfg.block_pattern)
    return replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=max(unit, 2) if unit > 1 else 2,
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=32,
        d_ff=256 if cfg.d_ff > 0 else 0,
        vocab_size=512,
        n_experts=min(4, cfg.n_experts),
        experts_per_token=min(2, cfg.experts_per_token),
        d_ff_expert=64 if cfg.d_ff_expert > 0 else 0,
        moe_group_size=64,
        ssm_d_state=8,
        ssm_dt_rank=8,
        ssm_chunk=16,
        sliding_window=16,
        q_chunk=16,
        kv_chunk=16,
        remat="none",
    )
