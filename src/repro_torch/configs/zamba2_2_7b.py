"""zamba2-2.7b [hybrid] — Mamba2 + weight-shared attn blocks [arXiv:2411.15242; hf].

54L d_model=2560 32H (GQA kv=32) d_ff=10240 vocab=32000, ssm_state=64.
Shared transformer block every 6 Mamba2 blocks (9 invocations).
"""
from ..models import ModelConfig, SSMConfig

ARCH_ID = "zamba2-2.7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="hybrid", n_layers=54, d_model=2560,
        n_heads=32, n_kv=32, d_ff=10240, vocab=32000, hybrid_group=6,
        ssm=SSMConfig(d_state=64, head_dim=64, expand=2, n_groups=1, chunk=256),
        act="geglu", rope_theta=10_000.0)


def smoke() -> ModelConfig:
    return config().replace(
        n_layers=4, d_model=64, n_heads=4, n_kv=4, d_ff=128, vocab=128,
        hybrid_group=2, ssm=SSMConfig(d_state=16, head_dim=16, chunk=16),
        attn_block_q=32, attn_block_kv=32)
