"""qwen1.5-4b [dense]: 40L d_model=2560 20H (GQA kv=20) d_ff=6912 vocab=151936.

QKV bias. [hf:Qwen/Qwen1.5-0.5B family; hf]
"""
from repro_torch.configs.base import ATTN_GLOBAL, ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    num_layers=40,
    d_model=2560,
    num_heads=20,
    num_kv_heads=20,
    head_dim=128,
    d_ff=6912,
    vocab_size=151_936,
    layer_pattern=(ATTN_GLOBAL,),
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
)
