"""Config system: ModelConfig covers all assigned architecture families.

A copy of the reference package's ``configs/base.py`` (standard library
only; the port imports nothing of the reference).  Every architecture maps
to one ModelConfig instance (``configs/<arch>.py``).  ``reduced()`` derives the small
same-family config used by CPU smoke tests; full configs are only ever
lowered via the dry-run (ShapeDtypeStruct, no allocation).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

# Layer kinds (per-layer static metadata; drives block construction).
ATTN_GLOBAL = 0
ATTN_LOCAL = 1
MAMBA2 = 2
RWKV6 = 3


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    shared_expert: bool = False      # llama4-style always-on shared expert
    moe_every: int = 1               # a MoE FFN every k-th layer (else dense)
    router_z_coef: float = 1e-3
    aux_coef: float = 1e-2
    combine_first: bool = False      # fold gates in before the w2 matmul


@dataclass(frozen=True)
class SSMConfig:
    # Mamba2 (SSD)
    state_dim: int = 64
    head_dim: int = 64
    expand: int = 2
    conv_kernel: int = 4
    chunk: int = 128
    # RWKV6
    rwkv_head_dim: int = 64
    rwkv_decay_lora: int = 64
    rwkv_chunk: int = 16


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads
    # attention behaviour
    layer_pattern: Tuple[int, ...] = ()   # repeating pattern of layer kinds
    window: int = 0                  # local-attention window (0 = full)
    attn_softcap: float = 0.0        # gemma2-style logit soft capping
    final_softcap: float = 0.0
    qkv_bias: bool = False
    qk_norm: bool = False            # gemma3
    attn_scale: float = 0.0          # 0 -> 1/sqrt(head_dim)
    # rope
    rope_theta: float = 10_000.0
    rope_theta_local: float = 0.0    # gemma3 uses a different theta for local layers
    mrope_sections: Tuple[int, ...] = ()  # qwen2-vl M-RoPE (t,h,w) sections
    # norm / mlp
    norm_eps: float = 1e-6
    use_layernorm: bool = False      # whisper uses LayerNorm, rest RMSNorm
    post_norms: bool = False         # gemma2/3 post-attn/ffn norms
    mlp_act: str = "silu"            # silu (SwiGLU) | gelu (GeGLU) | gelu_plain
    gated_mlp: bool = True
    embed_scale: bool = False        # gemma multiplies embeddings by sqrt(d)
    tie_embeddings: bool = True
    # mixtures / ssm
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    shared_attn_every: int = 0       # zamba2: shared (tied) attn block cadence
    # encoder-decoder (whisper)
    is_encdec: bool = False
    enc_layers: int = 0
    dec_layers: int = 0
    max_target_len: int = 448
    # stub modality frontend (vlm/audio): inputs are precomputed embeddings
    stub_frontend: bool = False
    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: bool = True
    remat_policy: str = "full"       # full | dots | none
    loss_chunk: int = 512            # chunked softmax-xent over sequence
    attn_chunk: int = 512            # KV-chunk of the online-softmax SW path

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm" and self.shared_attn_every == 0

    def layer_kinds(self) -> Tuple[int, ...]:
        """Per-layer kind for all num_layers, from the repeating pattern."""
        pat = self.layer_pattern or (ATTN_GLOBAL,)
        n = self.num_layers
        reps = (n + len(pat) - 1) // len(pat)
        return tuple((pat * reps)[:n])

    def sub_quadratic(self) -> bool:
        """True if long-context decode is admissible (assignment rule)."""
        kinds = set(self.layer_kinds())
        if kinds <= {MAMBA2, RWKV6}:
            return self.shared_attn_every == 0 or True  # hybrid allowed
        # attention archs: sub-quadratic iff every attn layer is windowed
        return ATTN_GLOBAL not in kinds and self.window > 0

    def reduced(self) -> "ModelConfig":
        """Small same-family config for CPU smoke tests."""
        changes = dict(
            name=self.name + "-smoke",
            num_layers=max(2, min(4, self.num_layers // 8)),
            d_model=128,
            num_heads=4,
            num_kv_heads=max(1, min(self.num_kv_heads, 4 * self.num_kv_heads // max(self.num_heads, 1), 4)),
            head_dim=32,
            d_ff=256,
            vocab_size=512,
            loss_chunk=64,
            remat=False,
        )
        if self.num_kv_heads == self.num_heads:
            changes["num_kv_heads"] = 4
        if self.mrope_sections:
            changes["mrope_sections"] = (8, 4, 4)
        if self.window:
            changes["window"] = 16
        if self.moe is not None:
            changes["moe"] = dataclasses.replace(self.moe, num_experts=4,
                                                 top_k=min(self.moe.top_k, 2))
        if self.ssm is not None:
            changes["ssm"] = dataclasses.replace(
                self.ssm, state_dim=16, head_dim=16, chunk=16,
                rwkv_head_dim=32, rwkv_decay_lora=16, rwkv_chunk=8)
        if self.shared_attn_every:
            changes["shared_attn_every"] = 2
        if self.is_encdec:
            changes["enc_layers"] = 2
            changes["dec_layers"] = 2
            changes["num_layers"] = 2
            changes["max_target_len"] = 32
        return dataclasses.replace(self, **changes)

    # approximate parameter counts (for roofline MODEL_FLOPS) -----------
    def param_count(self) -> int:
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        emb = v * d * (1 if self.tie_embeddings else 2)
        total = emb
        kinds = self.layer_kinds()
        for k in kinds:
            if k in (ATTN_GLOBAL, ATTN_LOCAL):
                attn = d * hd * (self.num_heads + 2 * self.num_kv_heads) + self.num_heads * hd * d
                total += attn + self._ffn_params()
            elif k == MAMBA2:
                di = self.ssm.expand * d
                nh = di // self.ssm.head_dim
                total += d * (2 * di + 2 * self.ssm.state_dim + nh) + di * d
                total += self._ffn_params()
            elif k == RWKV6:
                hK = self.ssm.rwkv_head_dim
                nh = d // hK
                total += 4 * d * d + 2 * d * self.ssm.rwkv_decay_lora  # time-mix
                total += 2 * d * f // 2  # channel-mix (r, k, v proj approx)
        if self.shared_attn_every:
            attn = d * hd * (self.num_heads + 2 * self.num_kv_heads) + self.num_heads * hd * d
            total += attn + d * f * 3  # one shared block
        if self.is_encdec:
            attn = 4 * d * d
            total += (self.enc_layers + 2 * self.dec_layers) * attn
            total += (self.enc_layers + self.dec_layers) * 2 * d * f
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE uses top_k of num_experts)."""
        if self.moe is None:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        dense = self.param_count()
        n_moe = len([i for i in range(self.num_layers)
                     if i % self.moe.moe_every == 0])
        expert_params = 3 * d * f
        total_expert = n_moe * self.moe.num_experts * expert_params
        active_expert = n_moe * self.moe.top_k * expert_params
        shared = n_moe * expert_params if self.moe.shared_expert else 0
        return dense - total_expert - shared + active_expert + shared

    def _ffn_params(self) -> int:
        d, f = self.d_model, self.d_ff
        base = 3 * d * f if self.gated_mlp else 2 * d * f
        if self.moe is not None:
            return self.moe.num_experts * base + (base if self.moe.shared_expert else 0)
        return base
