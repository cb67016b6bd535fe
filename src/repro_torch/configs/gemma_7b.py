"""gemma-7b [dense] — GeGLU, head_dim=256 [arXiv:2403.08295; hf].

28L d_model=3072 16H (GQA kv=16) d_ff=24576 vocab=256000.
"""
from ..models import ModelConfig

ARCH_ID = "gemma-7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense", n_layers=28, d_model=3072, n_heads=16,
        n_kv=16, d_head=256, d_ff=24576, vocab=256000, act="geglu",
        tie_embeddings=True)


def smoke() -> ModelConfig:
    return config().replace(n_layers=2, d_model=64, n_heads=4, n_kv=4,
                            d_head=32, d_ff=128, vocab=128,
                            attn_block_q=32, attn_block_kv=32)
