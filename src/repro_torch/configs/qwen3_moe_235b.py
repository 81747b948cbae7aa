"""Qwen3-235B-A22B — MoE 128 experts top-8, q/k-norm, decoupled head_dim
[hf:Qwen/Qwen3-30B-A3B; hf]. d_ff=1536 is the per-expert ffn width; there
is no dense MLP path."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
    d_ff=0, vocab_size=151936,
    block_pattern=("attn:moe",),
    n_experts=128, experts_per_token=8, d_ff_expert=1536,
    qk_norm=True, rope_theta=1e6,
)
