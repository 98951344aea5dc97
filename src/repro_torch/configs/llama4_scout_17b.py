"""llama4-scout-17b-a16e [moe]: 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16 experts top-1 + shared expert, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
"""
from repro_torch.configs.base import ATTN_GLOBAL, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202_048,
    layer_pattern=(ATTN_GLOBAL,),
    moe=MoEConfig(num_experts=16, top_k=1, shared_expert=True, moe_every=1,
                  capacity_factor=1.25),
    rope_theta=500_000.0,
    tie_embeddings=False,
)
