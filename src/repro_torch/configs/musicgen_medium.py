"""MusicGen-medium backbone — decoder-only over EnCodec tokens
[arXiv:2306.05284].

The EnCodec frontend is a STUB: input_specs() provides token ids for 4
codebooks (delay-pattern flattening assumed done upstream); the model sums
codebook embeddings and predicts 4 parallel heads.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio",
    num_layers=48, d_model=1536, num_heads=24, num_kv_heads=24, d_head=64,
    d_ff=6144, vocab_size=2048,
    pattern=("attn",), act="gelu", num_codebooks=4,
)
