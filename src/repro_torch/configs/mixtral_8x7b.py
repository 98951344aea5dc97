"""mixtral-8x7b [moe]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000.

8 experts top-2, sliding-window attention (4096). [arXiv:2401.04088; hf]
"""
from repro_torch.configs.base import ATTN_LOCAL, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32_000,
    layer_pattern=(ATTN_LOCAL,),   # SWA on every layer
    window=4096,
    moe=MoEConfig(num_experts=8, top_k=2, moe_every=1, capacity_factor=1.25),
    rope_theta=1_000_000.0,
    tie_embeddings=False,
)
