"""Qwen2-VL-2B backbone — M-RoPE, dynamic resolution [arXiv:2409.12191].

The vision frontend is a STUB per the assignment: input_specs() provides
precomputed patch embeddings (B, S, d_model) + 3-D M-RoPE position ids.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b", family="vlm",
    num_layers=28, d_model=1536, num_heads=12, num_kv_heads=2, d_head=128,
    d_ff=8960, vocab_size=151936,
    pattern=("attn",), qkv_bias=True,
    mrope=True, mrope_sections=(16, 24, 24),
    embed_inputs=False, rope_theta=1e6,
)
