"""minitron-4b [dense] — pruned nemotron, squared-ReLU MLP [arXiv:2407.14679; hf].

32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000.
"""
from ..models import ModelConfig

ARCH_ID = "minitron-4b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense", n_layers=32, d_model=3072, n_heads=24,
        n_kv=8, d_ff=9216, vocab=256000, act="relu2", tie_embeddings=False)


def smoke() -> ModelConfig:
    return config().replace(n_layers=2, d_model=64, n_heads=4, n_kv=2,
                            d_ff=128, vocab=128,
                            attn_block_q=32, attn_block_kv=32)
