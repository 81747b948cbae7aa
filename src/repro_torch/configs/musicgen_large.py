"""MusicGen-large backbone — decoder-only over EnCodec tokens
[arXiv:2306.05284; hf]. EnCodec frontend is a STUB per assignment:
input_specs provides precomputed frame embeddings (B, S, d_model); the
backbone is MHA (kv=32=H) with GELU MLP and sinusoidal positions."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=2048,
    ffn_act="gelu", rope_kind="sinusoidal",
    embed_inputs=False,
)
