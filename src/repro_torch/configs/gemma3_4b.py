"""gemma3-4b [dense] — 5:1 local:global attention, 128k ctx [hf:google/gemma-3; unverified].

34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144, head_dim=256,
sliding window 1024 on local layers, every 6th layer global.
Note: 34 % 6 != 0 — globals land at layer indices 5,11,17,23,29; the final
four layers (30-33) are local (schedule from window_schedule()).
"""
from ..models import ModelConfig

ARCH_ID = "gemma3-4b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense", n_layers=34, d_model=2560, n_heads=8,
        n_kv=4, d_head=256, d_ff=10240, vocab=262144, act="geglu",
        global_every=6, local_window=1024, rope_theta=1e6, tie_embeddings=True)


def smoke() -> ModelConfig:
    return config().replace(n_layers=4, d_model=64, n_heads=4, n_kv=2,
                            d_head=32, d_ff=128, vocab=128, global_every=2,
                            local_window=16, attn_block_q=32, attn_block_kv=32)
