"""Model configuration for all assigned architecture families.

The port's own copy of the reference's dataclasses (pure Python).  One
field differs: ``use_kernels`` (the reference's ``use_pallas``) takes the
hand-written CUDA kernels where the reference's gate admits its Pallas
kernels (flash attention K4, flash decode K3), and for the MoE expert GEMMs
(grouped matmul K6, which the reference's MoE never calls).

DeepSeek-V3's decoder (port-only): sigmoid scoring with a per-expert
selection bias, a routed scale, dropless dispatch, leading dense layers and latent attention (:class:`MLAConfig`).
They are the fields of :class:`DeepSeekMoEConfig`, a ``MoEConfig`` that
``ModelConfig.moe`` may hold, and ``MoEConfig`` gives each as a plain class
attribute at the value that computes what the reference does: so
``MoEConfig``'s and ``ModelConfig``'s own fields (and a registry model's
``asdict``) stay the reference's, and ``cfg.moe.scoring``,
``cfg.first_dense_layers`` or ``cfg.mla`` read alike on every model.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple, Union


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int           # per-expert hidden dim (assignment's d_ff for MoE archs)
    capacity_factor: float = 1.25
    router_dtype: str = "float32"
    n_shared_experts: int = 0  # always-on shared expert(s)

    # DeepSeekMoEConfig's fields, at the values of the reference's MoE (class
    # attributes, not fields)
    scoring = "softmax"
    selection_bias = False
    routed_scale = 1.0
    dropless = False
    first_dense_layers = 0
    mla = None                 # Optional[MLAConfig]


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (DeepSeek-V2/V3) without a query
    low-rank: keys and values come from one normed ``kv_lora_rank`` latent
    a token, plus one ``qk_rope_head_dim`` rotary key shared by every head;
    the decode cache holds the two (``kv_lora_rank + qk_rope_head_dim``
    values a token and layer)."""
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def cache_width(self) -> int:
        return self.kv_lora_rank + self.qk_rope_head_dim


_MOE_FIELDS = frozenset(f.name for f in dataclasses.fields(MoEConfig))


@dataclass(frozen=True)
class DeepSeekMoEConfig(MoEConfig):
    """The MoE of DeepSeek-V3's decoder (Moonlight-16B-A3B), and the rest of
    its block.  Made with none of its own fields given, it is the
    reference's plain ``MoEConfig``: a configuration file's ``moe`` object
    of ``MoEConfig``'s fields alone builds what the registry's models hold."""
    # "softmax": top-k of the softmax; "sigmoid": top-k of sigmoid scores
    # (DeepSeek-V3's scoring_func), each token's weights its bare scores
    scoring: str = "softmax"
    # a learned per-expert bias added to the scores for selection only
    # (DeepSeek-V3's e_score_correction_bias; topk_method noaux_tc)
    selection_bias: bool = False
    routed_scale: float = 1.0  # routed experts' output scale (routed_scaling_factor)
    # every assignment is computed (capacity_factor is not used): the expert
    # buffer holds every token, and K6 computes no row past an expert's count
    dropless: bool = False
    # the first layers take a dense MLP of the model's d_ff, the rest the
    # MoE FFN (first_k_dense_replace)
    first_dense_layers: int = 0
    # latent attention in every layer in place of GQA (the model's n_kv and
    # d_head unused)
    mla: Optional[MLAConfig] = None

    def __new__(cls, *args, **kw):
        if (args or kw) and len(args) <= len(_MOE_FIELDS) and set(kw) <= _MOE_FIELDS:
            return MoEConfig(*args, **kw)
        return super().__new__(cls)


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256            # SSD chunk length

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None            # default d_model // n_heads
    act: str = "swiglu"                     # swiglu | geglu | gelu
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    rms_eps: float = 1e-6
    tie_embeddings: bool = True
    logit_softcap: float = 0.0

    # attention pattern: every `global_every`-th layer is global, others use a
    # sliding window of `local_window` (gemma3's 5:1 local:global).  0 = all global.
    global_every: int = 0
    local_window: int = 1024

    # encoder-decoder (seamless-m4t): n_layers is the decoder depth.
    encoder_layers: int = 0

    # modality frontend STUB: the backbone consumes `frontend_seq` precomputed
    # embeddings (ViT patches / audio frames) supplied by input_specs().
    frontend: Optional[str] = None          # None | vision | audio
    frontend_seq: int = 0

    # a DeepSeekMoEConfig where the model is DeepSeek-V3's (built from a
    # nested object of this name: the first class of the hint)
    moe: Optional[Union[DeepSeekMoEConfig, MoEConfig]] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2): a weight-shared attention block runs after every
    # `hybrid_group` SSM blocks.
    hybrid_group: int = 0

    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: str = "full"                     # none | full
    # §Perf lever: pin the MoE dispatch buffers' shardings (expert axis on
    # `model`, tokens on `data`) so the scatter/gather lowers to all-to-all
    # instead of a replicated [E·C, D] buffer + all-reduce.
    moe_shard_dispatch: bool = False
    # §Perf lever: dispatch within G independent token groups (aligned to the
    # data-parallel shards) — the global argsort/scatter becomes shard-local,
    # capacity is enforced per group (standard per-device capacity), and only
    # the [G, E, C/G, D] buffer crosses the network (all-to-all to the
    # expert-sharded layout).
    moe_dispatch_groups: int = 1
    # §Perf lever (iteration 3): all-gather expert outputs (bf16) over the
    # expert axis before the combine so the gather/scatter stays shard-local
    # instead of lowering to masked f32 all-reduces of [T·k, D].
    moe_combine_replicated: bool = False
    # attention implementation: "blockwise" (memory-efficient lax.scan flash)
    # or "dense" (materialized scores; only sane for short seq)
    attn_impl: str = "blockwise"
    attn_block_q: int = 512
    attn_block_kv: int = 1024
    use_kernels: bool = False               # hand-written kernels: attention, expert GEMMs

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else self.d_model // self.n_heads

    @property
    def mla(self) -> Optional[MLAConfig]:
        """Latent attention in every layer (DeepSeek-V3), or None: GQA."""
        return None if self.moe is None else self.moe.mla

    @property
    def first_dense_layers(self) -> int:
        """Leading layers of a moe model that take a dense MLP of ``d_ff``."""
        return 0 if self.moe is None else self.moe.first_dense_layers

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """True if serve-time cost per token is o(seq): SSM state or hybrid."""
        return self.family in ("ssm", "hybrid")

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Parameter counting (used for MODEL_FLOPS = 6·N·D in §Roofline)
# ---------------------------------------------------------------------------
def _attn_params(cfg: ModelConfig) -> int:
    if cfg.mla is not None:
        return _mla_params(cfg)
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    n = d * h * dh + 2 * d * kv * dh + h * dh * d     # q, k, v, o
    if cfg.qkv_bias:
        n += h * dh + 2 * kv * dh
    return n


def _mla_params(cfg: ModelConfig) -> int:
    m, d, h = cfg.mla, cfg.d_model, cfg.n_heads
    return (d * h * m.qk_head_dim                       # q
            + d * m.cache_width + m.kv_lora_rank        # latent + rope key, latent norm
            + m.kv_lora_rank * h * (m.qk_nope_head_dim + m.v_head_dim)   # k, v up
            + h * m.v_head_dim * d)                     # o


def _mlp_params(d_model: int, d_ff: int, act: str) -> int:
    gates = 2 if act in ("swiglu", "geglu") else 1
    return gates * d_model * d_ff + d_ff * d_model


def _ssm_params(cfg: ModelConfig) -> int:
    s = cfg.ssm
    d, di = cfg.d_model, s.d_inner(cfg.d_model)
    nh, ng, N = s.n_heads(cfg.d_model), s.n_groups, s.d_state
    conv_ch = di + 2 * ng * N
    n = d * (2 * di + 2 * ng * N + nh)       # in_proj -> z, x, B, C, dt
    n += conv_ch * s.d_conv + conv_ch        # depthwise conv + bias
    n += nh * 3                              # A_log, D, dt_bias
    n += di                                  # gated norm
    n += di * d                              # out_proj
    return n


def _moe_layer_params(cfg: ModelConfig) -> Tuple[int, int]:
    """(total, active) params of one MoE FFN layer."""
    m = cfg.moe
    per_expert = _mlp_params(cfg.d_model, m.d_ff_expert, cfg.act)
    router = cfg.d_model * m.n_experts + (m.n_experts if m.selection_bias else 0)
    shared = m.n_shared_experts * per_expert
    total = m.n_experts * per_expert + router + shared
    active = m.top_k * per_expert + router + shared
    return total, active


def param_count(cfg: ModelConfig) -> Tuple[int, int]:
    """Returns (total, active) parameter counts for the backbone."""
    d = cfg.d_model
    embed = cfg.vocab * d
    unembed = 0 if cfg.tie_embeddings else cfg.vocab * d
    total = active = embed + unembed + d  # + final norm

    def norm() -> int:
        return d

    if cfg.family in ("dense", "vlm", "audio", "encdec", "moe"):
        attn = _attn_params(cfg)
        if cfg.family == "moe":
            ffn_total, ffn_active = _moe_layer_params(cfg)
        else:
            ffn_total = ffn_active = _mlp_params(d, cfg.d_ff, cfg.act)
        per_layer_total = attn + ffn_total + 2 * norm()
        per_layer_active = attn + ffn_active + 2 * norm()
        n_moe = cfg.n_layers
        if cfg.first_dense_layers:
            n_moe -= cfg.first_dense_layers
            dense = (attn + _mlp_params(d, cfg.d_ff, cfg.act) + 2 * norm()) \
                * cfg.first_dense_layers
            total += dense
            active += dense
        total += n_moe * per_layer_total
        active += n_moe * per_layer_active
        if cfg.is_encdec:
            enc_layer = attn + _mlp_params(d, cfg.d_ff, cfg.act) + 2 * norm()
            cross = _attn_params(cfg) + norm()
            total += cfg.encoder_layers * enc_layer + cfg.n_layers * cross
            active += cfg.encoder_layers * enc_layer + cfg.n_layers * cross
    elif cfg.family == "ssm":
        per_layer = _ssm_params(cfg) + norm()
        total += cfg.n_layers * per_layer
        active += cfg.n_layers * per_layer
    elif cfg.family == "hybrid":
        per_layer = _ssm_params(cfg) + norm()
        total += cfg.n_layers * per_layer
        active += cfg.n_layers * per_layer
        shared_attn = _attn_params(cfg) + _mlp_params(d, cfg.d_ff, cfg.act) + 2 * norm()
        total += shared_attn            # one weight-shared block
        n_invocations = cfg.n_layers // max(cfg.hybrid_group, 1)
        active += shared_attn           # weights counted once; reused
    else:
        raise ValueError(cfg.family)
    return total, active
