"""qwen2-72b [dense] — GQA with QKV bias [arXiv:2407.10671; hf].

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064.
"""
from ..models import ModelConfig

ARCH_ID = "qwen2-72b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense", n_layers=80, d_model=8192, n_heads=64,
        n_kv=8, d_ff=29568, vocab=152064, act="swiglu", qkv_bias=True,
        rope_theta=1e6, tie_embeddings=False)


def smoke() -> ModelConfig:
    return config().replace(n_layers=2, d_model=64, n_heads=8, n_kv=2,
                            d_ff=128, vocab=128,
                            attn_block_q=32, attn_block_kv=32)
