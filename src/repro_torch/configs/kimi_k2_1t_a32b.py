"""kimi-k2-1t-a32b [moe] — trillion-param MoE (paper-table) [arXiv:2501.kimi2; unverified].

61L d_model=7168 64H (GQA kv=8, head_dim=128) expert d_ff=2048 vocab=163840,
384 experts top-8.  Optimizer states run in bf16 for this arch (DESIGN.md
§memory): fp32 Adam would exceed 16 GB/chip HBM even at 512 chips.
"""
from ..models import ModelConfig, MoEConfig

ARCH_ID = "kimi-k2-1t-a32b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="moe", n_layers=61, d_model=7168, n_heads=64,
        n_kv=8, d_head=128, d_ff=2048, vocab=163840, act="swiglu",
        moe=MoEConfig(n_experts=384, top_k=8, d_ff_expert=2048,
                      capacity_factor=1.25), tie_embeddings=False)


def smoke() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv=2, d_head=32, d_ff=32,
        vocab=128,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32, capacity_factor=2.0),
        attn_block_q=32, attn_block_kv=32)
