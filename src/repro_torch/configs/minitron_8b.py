"""Minitron-8B — width-pruned Nemotron-4, squared-ReLU MLP
[arXiv:2407.14679; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=16384, vocab_size=256000,
    ffn_act="relu2",
)
