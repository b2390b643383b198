"""RWKV-6 "Finch" 3B — attention-free, data-dependent decay
[arXiv:2404.05892]."""
from repro_torch.configs.base import ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="ssm",
    num_layers=32, d_model=2560, num_heads=40, num_kv_heads=40, d_head=64,
    d_ff=8960, vocab_size=65536,
    pattern=("rwkv",),
    rwkv=RWKVConfig(head_size=64, decay_lora=64, mix_lora=32),
)
