"""Jamba v0.1 52B — Mamba+attention 1:7 interleave, 16-expert MoE every
other layer [arXiv:2403.19887].

Period-8 block (indices 0-7): attention at index 4, Mamba elsewhere;
MoE replaces the MLP at odd indices.  4 repeats = 32 layers.
"""
from repro_torch.configs.base import MambaConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8, d_head=128,
    d_ff=14336, vocab_size=65536,
    pattern=("mamba", "mamba_moe", "mamba", "mamba_moe",
             "attn", "mamba_moe", "mamba", "mamba_moe"),
    moe=MoEConfig(num_experts=16, top_k=2, d_expert=14336),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    fsdp=True, param_dtype="bfloat16", 
)
