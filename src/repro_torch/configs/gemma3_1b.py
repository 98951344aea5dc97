"""gemma3-1b [dense]: 26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144.

5:1 local:global (window 512), qk-norm, dual rope thetas, 128k context.
[hf:google/gemma-3-1b-pt; unverified]
"""
from repro_torch.configs.base import ATTN_GLOBAL, ATTN_LOCAL, ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    num_layers=26,
    d_model=1152,
    num_heads=4,
    num_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262_144,
    layer_pattern=(ATTN_LOCAL,) * 5 + (ATTN_GLOBAL,),
    window=512,
    qk_norm=True,
    final_softcap=0.0,
    mlp_act="gelu",
    post_norms=True,
    embed_scale=True,
    rope_theta=1_000_000.0,
    rope_theta_local=10_000.0,
    tie_embeddings=True,
)
