"""Jamba-v0.1 52B — Mamba+attention 1:7, MoE 16e top-2 every other layer
[arXiv:2403.19887; hf]. HF config: attn period 8 offset 4, expert period 2
offset 1; no positional encoding (Mamba provides position)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=65536,
    block_pattern=(
        "mamba:dense", "mamba:moe", "mamba:dense", "mamba:moe",
        "attn:dense", "mamba:moe", "mamba:dense", "mamba:moe",
    ),
    n_experts=16, experts_per_token=2, d_ff_expert=14336,
    rope_kind="none",
    ssm_d_state=16, ssm_conv_dim=4, ssm_expand=2,
    long_context_ok=True,   # Mamba majority; attn 1:7 uses KV cache at decode
)
