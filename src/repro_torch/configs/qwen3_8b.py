"""Qwen3-8B — qk-norm, GQA [hf:Qwen/Qwen3-8B]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b", family="dense",
    num_layers=36, d_model=4096, num_heads=32, num_kv_heads=8, d_head=128,
    d_ff=12288, vocab_size=151936,
    pattern=("attn",), qk_norm=True, rope_theta=1e6,
)
