"""moonshot-v1-16b-a3b [moe] — kimi/moonlight MoE [hf:moonshotai/Moonlight-16B-A3B; hf].

48L d_model=2048 16H (GQA kv=16) expert d_ff=1408 vocab=163840, 64 experts top-6.
"""
from ..models import ModelConfig, MoEConfig

ARCH_ID = "moonshot-v1-16b-a3b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="moe", n_layers=48, d_model=2048, n_heads=16,
        n_kv=16, d_ff=1408, vocab=163840, act="swiglu",
        moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408,
                      capacity_factor=1.25))


def smoke() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv=4, d_ff=32, vocab=128,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=32, capacity_factor=2.0),
        attn_block_q=32, attn_block_kv=32)
