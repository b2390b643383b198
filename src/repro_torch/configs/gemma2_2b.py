"""Gemma-2 2B — local+global alternating attention, logit softcaps
[arXiv:2408.00118]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b", family="dense",
    num_layers=26, d_model=2304, num_heads=8, num_kv_heads=4, d_head=256,
    d_ff=9216, vocab_size=256000,
    pattern=("local", "global"), sliding_window=4096,
    attn_softcap=50.0, logit_softcap=30.0,
    act="gelu", tie_embeddings=True, embed_scale=True, post_block_norm=True,
)
