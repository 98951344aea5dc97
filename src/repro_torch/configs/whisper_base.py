"""whisper-base [audio]: 6L enc + 6L dec, d_model=512 8H d_ff=2048 vocab=51865.

Encoder-decoder; conv frontend is a STUB (``input_specs()`` provides
precomputed frame embeddings). LayerNorm + plain GELU MLPs, sinusoidal /
learned positions. [arXiv:2212.04356; unverified]
"""
from repro_torch.configs.base import ATTN_GLOBAL, ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    num_layers=6,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51_865,
    layer_pattern=(ATTN_GLOBAL,),
    use_layernorm=True,
    norm_eps=1e-5,
    mlp_act="gelu_plain",
    gated_mlp=False,
    is_encdec=True,
    enc_layers=6,
    dec_layers=6,
    max_target_len=448,
    stub_frontend=True,
    tie_embeddings=True,
)
