"""SmolLM-360M — llama-arch small [hf:HuggingFaceTB/SmolLM-360M]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m", family="dense",
    num_layers=32, d_model=960, num_heads=15, num_kv_heads=5, d_head=64,
    d_ff=2560, vocab_size=49152,
    pattern=("attn",), tie_embeddings=True,
)
