"""OLMoE-1B-7B — 64 experts, top-8 [arXiv:2409.02060]."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe",
    num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16, d_head=128,
    d_ff=1024, vocab_size=50304,
    pattern=("attn_moe",),
    moe=MoEConfig(num_experts=64, top_k=8, d_expert=1024),
    qk_norm=True,
)
