"""xLSTM-125M — alternating mLSTM/sLSTM blocks, d_ff=0 (blocks carry their
own projections) [arXiv:2405.04517; unverified]. The published 125M config
does not pin the m:s ratio; we use 1:1 (noted in DESIGN.md)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50304,
    block_pattern=("mlstm", "slstm"),
    rope_kind="none",
    long_context_ok=True,   # O(1) recurrent state
)
