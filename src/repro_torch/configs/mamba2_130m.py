"""mamba2-130m [ssm] — SSD (state-space duality) [arXiv:2405.21060; unverified].

24L d_model=768 (attention-free) vocab=50280, ssm_state=128.
d_inner = 2·768 = 1536, head_dim 64 → 24 SSD heads.
"""
from ..models import ModelConfig, SSMConfig

ARCH_ID = "mamba2-130m"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="ssm", n_layers=24, d_model=768, n_heads=0,
        n_kv=0, d_ff=0, vocab=50280,
        ssm=SSMConfig(d_state=128, head_dim=64, expand=2, n_groups=1, chunk=256))


def smoke() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=64, vocab=128,
        ssm=SSMConfig(d_state=16, head_dim=16, chunk=16))
