"""qwen2-vl-7b [vlm]: 28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.

M-RoPE (t,h,w sections), dynamic resolution; vision frontend is a STUB —
``input_specs()`` provides precomputed patch embeddings + 3D positions.
[arXiv:2409.12191; hf]
"""
from repro_torch.configs.base import ATTN_GLOBAL, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152_064,
    layer_pattern=(ATTN_GLOBAL,),
    qkv_bias=True,
    mrope_sections=(16, 24, 24),
    rope_theta=1_000_000.0,
    stub_frontend=True,
    tie_embeddings=False,
)
