"""Model / parallelism / quantization configuration system.

Every assigned architecture is a ``ModelConfig`` instance in its own module
(``repro/configs/<arch>.py``).  ``scaled()`` produces the reduced smoke-test
variant of the same family.  The paper's technique surfaces here as
``quant="binary"`` (BinaryNet W1A1 projections, STE-trained) and
``width_mult`` (the chip's S knob generalized to any width).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int                    # per-expert FFN hidden dim
    num_shared_experts: int = 0      # DeepSeek/Kimi-style always-on experts
    capacity_factor: float = 1.25
    router_aux_weight: float = 1e-2  # load-balance loss weight
    impl: str = "auto"               # auto | dense | ep (expert-parallel a2a)
    # perf knob (§Perf): fp8 dispatch a2a (DeepSeek-V3 style) — halves the
    # dominant wire-bytes term of EP MoE; return path stays bf16.
    dispatch_fp8: bool = False


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: Optional[int] = None    # defaults to ceil(d_model/16)
    # perf knob (§Perf): unroll the selective-scan recurrence so the
    # (B, d_inner, d_state) state round-trips HBM once per `scan_unroll`
    # steps instead of every token (XLA fuses the unrolled chain).
    scan_unroll: int = 1


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    head_size: int = 64
    decay_lora: int = 64             # rank of the data-dependent decay LoRA
    mix_lora: int = 32               # rank of the ddlerp token-shift LoRA
    # perf knobs (EXPERIMENTS.md §Perf): the WKV recurrence is the memory-
    # roofline bottleneck of rwkv6 at train/prefill.
    scan_unroll: int = 1             # lax.scan unroll of the per-token path
    chunk: Optional[int] = None      # GLA-style chunked WKV (tokens/chunk)
    sub_chunk: int = 16              # FLA-style sub-chunks within a chunk:
    #   cross-sub-chunk decay runs as rebased (c, C) matmuls, the exact
    #   pairwise einsum only within a sub-chunk (must divide `chunk`;
    #   a non-divisor falls back to one exact sub-chunk = the full chunk)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # identity
    name: str
    family: str                      # dense | moe | vlm | audio | hybrid | ssm
    # trunk
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: Optional[int] = None     # default d_model // num_heads
    # block structure: `pattern` is scanned `num_layers // len(pattern)` times
    # after `prefix` (unscanned leading layers). entries:
    #   attn | attn_moe | local | global | mamba | mamba_moe | rwkv | dense
    pattern: Tuple[str, ...] = ("attn",)
    prefix: Tuple[str, ...] = ()
    # attention details
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    qk_norm: bool = False
    attn_softcap: Optional[float] = None
    logit_softcap: Optional[float] = None
    sliding_window: Optional[int] = None   # for "local" pattern entries
    mrope: bool = False                    # Qwen2-VL multimodal RoPE
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)  # t/h/w halves of d_head
    # embeddings / head
    tie_embeddings: bool = False
    embed_scale: bool = False              # gemma: multiply embeds by sqrt(d)
    num_codebooks: int = 1                 # MusicGen: EnCodec codebooks
    embed_inputs: bool = True              # False for VLM stub (precomputed embeds)
    # ffn / norm
    act: str = "silu"                      # silu | gelu
    norm_eps: float = 1e-6
    post_block_norm: bool = False          # gemma2 post-norms
    # sub-configs
    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    rwkv: Optional[RWKVConfig] = None
    # the paper's technique
    quant: str = "none"                    # none | binary (W1A1 + STE)
    width_mult: float = 1.0                # BinarEye S-knob generalization
    # numerics / training
    dtype: str = "bfloat16"                # activation/compute dtype
    param_dtype: str = "float32"           # bfloat16 for the FSDP giants
    attn_probs_bf16: bool = False          # bf16 exp'd probs (perf knob, §Perf)
    bf16_grads: bool = False               # Megatron-style bf16 grad collectives
    remat: bool = True
    loss_chunk: int = 1024                 # CE computed over seq chunks
    optimizer: str = "adamw"               # adamw | adafactor | sgdm
    # parallelism
    fsdp: bool = False                     # shard params/opt over data axes
    seq_shard_attn: bool = False           # shard seq over model axis in attn I/O

    # ---- derived ----------------------------------------------------------
    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else self.d_model // self.num_heads

    @property
    def num_pattern_repeats(self) -> int:
        n = self.num_layers - len(self.prefix)
        assert n % len(self.pattern) == 0, (self.name, n, self.pattern)
        return n // len(self.pattern)

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def scaled(self, layers: int = None, width: int = 64) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests."""
        factor = max(1, self.d_model // width)
        def shrink(x, lo=8):
            return max(lo, int(x) // factor)
        n_pat = len(self.pattern)
        nl = layers if layers is not None else len(self.prefix) + n_pat
        nl = max(nl, len(self.prefix) + n_pat)
        nl = len(self.prefix) + ((nl - len(self.prefix) + n_pat - 1) // n_pat) * n_pat
        heads = max(2, self.num_heads // 8)
        kv = max(1, min(heads, self.num_kv_heads // 8 or 1))
        while heads % kv:
            kv -= 1
        moe = None
        if self.moe:
            moe = dataclasses.replace(
                self.moe, num_experts=min(8, self.moe.num_experts),
                top_k=min(2, self.moe.top_k), d_expert=shrink(self.moe.d_expert),
                num_shared_experts=min(1, self.moe.num_shared_experts))
        mamba = self.mamba and dataclasses.replace(self.mamba, d_state=8)
        rwkv = self.rwkv and dataclasses.replace(
            self.rwkv, head_size=16, decay_lora=8, mix_lora=8)
        d_model = shrink(self.d_model, lo=32)
        d_model = max(d_model, heads * 8)
        # head_dim must be even (RoPE) and divide d_model exactly
        d_head_s = max(8, (d_model // heads) // 2 * 2)
        d_model = heads * d_head_s
        if self.rwkv:  # d_model must be a multiple of the rwkv head size
            d_model = max(16, d_model // 16 * 16)
        hd2 = (d_model // heads) // 2
        sec = (hd2 // 4, (hd2 - hd2 // 4) // 2,
               hd2 - hd2 // 4 - (hd2 - hd2 // 4) // 2)
        return dataclasses.replace(
            self, name=self.name + "-smoke", num_layers=nl, d_model=d_model,
            num_heads=heads, num_kv_heads=kv,
            d_head=max(8, (d_model // heads) // 2 * 2),
            d_ff=shrink(self.d_ff, lo=16),
            vocab_size=min(512, self.vocab_size),
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else None,
            moe=moe, mamba=mamba, rwkv=rwkv, loss_chunk=64, fsdp=False,
            mrope_sections=sec if self.mrope else self.mrope_sections,
            remat=False,  # halves XLA compile time on the 1-core CI box
        )


def eff_d_ff(cfg: ModelConfig) -> int:
    """FFN width after the BinarEye S-knob (width_mult)."""
    return max(8, int(cfg.d_ff * cfg.width_mult))


def eff_d_expert(cfg: ModelConfig) -> int:
    return max(8, int(cfg.moe.d_expert * cfg.width_mult))


def param_count(cfg: ModelConfig) -> int:
    """Approximate parameter count (embeddings + blocks), for roofline's 6ND."""
    d, v = cfg.d_model, cfg.vocab_size
    dh = cfg.head_dim
    n = v * d * (1 if cfg.tie_embeddings else 2) * (cfg.num_codebooks if cfg.num_codebooks > 1 else 1)
    def attn_params():
        return d * dh * (cfg.num_heads + 2 * cfg.num_kv_heads) + cfg.num_heads * dh * d
    def mlp_params(ff):
        return 3 * d * ff
    def moe_params():
        m = cfg.moe
        return (m.num_experts + m.num_shared_experts) * 3 * d * eff_d_expert(cfg) + m.num_experts * d
    def mamba_params():
        mc = cfg.mamba
        di = mc.expand * d
        dtr = mc.dt_rank or -(-d // 16)
        return d * 2 * di + di * mc.d_conv + di * (dtr + 2 * mc.d_state) + dtr * di + di * mc.d_state + di + di * d
    def rwkv_params():
        rc = cfg.rwkv
        tm = 5 * d * d + 2 * d * rc.decay_lora + 10 * d * rc.mix_lora
        cm = 2 * d * eff_d_ff(cfg) + d * d
        return tm + cm
    total = n
    for kind in cfg.prefix + cfg.pattern * cfg.num_pattern_repeats:
        if kind in ("attn", "local", "global"):
            total += attn_params() + mlp_params(eff_d_ff(cfg))
        elif kind == "dense":
            total += attn_params() + mlp_params(eff_d_ff(cfg))
        elif kind == "attn_moe":
            total += attn_params() + moe_params()
        elif kind == "mamba":
            total += mamba_params() + mlp_params(eff_d_ff(cfg))
        elif kind == "mamba_moe":
            total += mamba_params() + moe_params()
        elif kind == "rwkv":
            total += rwkv_params()
        else:
            raise ValueError(kind)
    return int(total)


def active_param_count(cfg: ModelConfig) -> int:
    """Active params per token (MoE: top_k + shared experts only)."""
    if cfg.moe is None:
        return param_count(cfg)
    d = cfg.d_model
    m = cfg.moe
    full_moe = (m.num_experts + m.num_shared_experts) * 3 * d * eff_d_expert(cfg)
    act_moe = (m.top_k + m.num_shared_experts) * 3 * d * eff_d_expert(cfg)
    n_moe_layers = sum(1 for k in cfg.prefix + cfg.pattern * cfg.num_pattern_repeats
                       if k.endswith("_moe"))
    return param_count(cfg) - n_moe_layers * (full_moe - act_moe)
