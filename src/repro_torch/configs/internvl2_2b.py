"""internvl2-2b [vlm] — InternViT + InternLM2 backbone [arXiv:2404.16821; hf].

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553.
ViT frontend is a STUB: input_specs() supplies 256 patch embeddings prepended
to the text sequence (text length = assigned seq_len − 256).
"""
from ..models import ModelConfig

ARCH_ID = "internvl2-2b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="vlm", n_layers=24, d_model=2048, n_heads=16,
        n_kv=8, d_ff=8192, vocab=92553, act="swiglu", frontend="vision",
        frontend_seq=256, tie_embeddings=False)


def smoke() -> ModelConfig:
    return config().replace(n_layers=2, d_model=64, n_heads=4, n_kv=2,
                            d_ff=128, vocab=128, frontend_seq=8,
                            attn_block_q=32, attn_block_kv=32)
