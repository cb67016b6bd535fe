"""seamless-m4t-large-v2 [audio] — enc-dec multimodal backbone [arXiv:2308.11596; hf].

24L(dec)+24L(enc) d_model=1024 16H (kv=16) d_ff=8192 vocab=256206.
Audio frontend is a STUB: input_specs() supplies precomputed frame embeddings.
Assigned seq_len S splits S/2 encoder frames + S/2 decoder tokens (DESIGN.md).
"""
from ..models import ModelConfig

ARCH_ID = "seamless-m4t-large-v2"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="encdec", n_layers=24, encoder_layers=24,
        d_model=1024, n_heads=16, n_kv=16, d_ff=8192, vocab=256206,
        act="gelu", frontend="audio", frontend_seq=0, tie_embeddings=True)


def smoke() -> ModelConfig:
    return config().replace(n_layers=2, encoder_layers=2, d_model=64,
                            n_heads=4, n_kv=4, d_ff=128, vocab=128,
                            attn_block_q=32, attn_block_kv=32)
