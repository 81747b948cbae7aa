"""Gemma-3 4B — 5:1 local:global attention, 262k vocab, tied embeddings
[hf:google/gemma-3-1b-pt; unverified]. head_dim=256 per the published HF
config (d_model/n_heads would give 320; Gemma decouples head_dim)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b", family="dense",
    n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4, head_dim=256,
    d_ff=10240, vocab_size=262144,
    block_pattern=("attn_local",) * 5 + ("attn",),
    sliding_window=1024, rope_theta=1e6,
    tie_embeddings=True,
    long_context_ok=True,   # sliding-window local layers dominate (5:1)
)
