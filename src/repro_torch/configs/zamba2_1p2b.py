"""zamba2-1.2b [hybrid]: Mamba2 backbone + shared (tied) attention blocks.

38L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=32000 ssm_state=64
[arXiv:2411.15242; hf]
"""
from repro_torch.configs.base import MAMBA2, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32_000,
    layer_pattern=(MAMBA2,),
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, conv_kernel=4, chunk=128),
    shared_attn_every=6,      # one tied attention+MLP block applied every 6 mamba layers
    rope_theta=10_000.0,
    tie_embeddings=True,
)
