"""rwkv6-1.6b [ssm] "Finch": 24L d_model=2048 (attn-free) d_ff=7168 vocab=65536.

Data-dependent decay WKV recurrence. [arXiv:2404.05892; unverified]
"""
from repro_torch.configs.base import RWKV6, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    num_layers=24,
    d_model=2048,
    num_heads=32,            # d_model / rwkv_head_dim
    num_kv_heads=32,
    head_dim=64,
    d_ff=7168,
    vocab_size=65_536,
    layer_pattern=(RWKV6,),
    ssm=SSMConfig(rwkv_head_dim=64, rwkv_decay_lora=64, rwkv_chunk=16),
    gated_mlp=False,         # rwkv channel-mix is its own structure
    tie_embeddings=False,
)
