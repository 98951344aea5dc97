"""gemma2-2b [dense]: 26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000.

Local(4096)/global alternating, attn logit softcap 50, final softcap 30,
GeGLU, pre+post norms, sqrt(d) embedding scale. [arXiv:2408.00118; hf]
"""
from repro_torch.configs.base import ATTN_GLOBAL, ATTN_LOCAL, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256_000,
    layer_pattern=(ATTN_LOCAL, ATTN_GLOBAL),
    window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    mlp_act="gelu",
    post_norms=True,
    embed_scale=True,
    rope_theta=10_000.0,
    tie_embeddings=True,
)
