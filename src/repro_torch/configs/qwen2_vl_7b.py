"""Qwen2-VL-7B backbone — M-RoPE, QKV bias [arXiv:2409.12191; hf].
Vision frontend is a STUB per assignment: input_specs provides token ids +
3D (t,h,w) M-RoPE position ids (patch embeddings precomputed upstream)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b", family="vlm",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
    d_ff=18944, vocab_size=152064,
    qkv_bias=True, rope_kind="mrope", rope_theta=1e6,
)
