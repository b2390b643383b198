"""Qwen1.5-110B — dense, QKV bias [hf:Qwen/Qwen1.5-110B family]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b", family="dense",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8, d_head=128,
    d_ff=49152, vocab_size=152064,
    pattern=("attn",), qkv_bias=True, fsdp=True, param_dtype="bfloat16",  rope_theta=1e6,
)
