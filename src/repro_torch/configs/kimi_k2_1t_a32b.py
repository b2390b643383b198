"""Kimi K2 — trillion-param MoE (384 experts, top-8) [arXiv:2501.kimi2].

61 layers: 1 dense prefix layer + 60 MoE layers (DeepSeek-V3-style layout
with one shared expert).  Adafactor + full FSDP: 1T params do not fit
per-chip optimizer state otherwise.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    num_layers=61, d_model=7168, num_heads=64, num_kv_heads=8, d_head=128,
    d_ff=2048, vocab_size=163840,
    prefix=("dense",), pattern=("attn_moe",),
    moe=MoEConfig(num_experts=384, top_k=8, d_expert=2048,
                  num_shared_experts=1),
    optimizer="adafactor", fsdp=True, param_dtype="bfloat16",  rope_theta=5e4,
)
