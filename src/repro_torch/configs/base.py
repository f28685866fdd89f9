"""Model configuration system (copy of ``repro/configs/base.py``).

The port keeps its own copy so that it imports nothing of the JAX package;
only the registry's import list differs.  The scan-related fields
(``scan_layers``, ``remat``, ``sharding_mode``, ``tp_degree``) are kept
so a config compares field for field with the reference; the port's
serving path runs the stack as a Python loop and ignores them.

Every assigned architecture is expressed as a ModelConfig built from LayerSpec
super-blocks: the layer stack is ``superblock * repeat`` (+ optional remainder),
which maps 1:1 onto ``jax.lax.scan`` over stacked parameters in
``models/transformer.py``.  Heterogeneous stacks (Jamba's 1:7 attn:mamba
interleave, xLSTM's sLSTM/mLSTM alternation) are fixed structures *within* the
super-block, so the scan stays homogeneous.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

from repro_torch.core.precision import ALLOWED_DTYPES

FULL_ATTENTION = -1  # sentinel: no sliding window


@dataclass(frozen=True)
class LayerSpec:
    """Static structure of one layer inside a super-block."""

    mixer: str = "attn"  # attn | mamba | mlstm | slstm | none
    ffn: str = "mlp"  # mlp | moe | none
    window: int = FULL_ATTENTION  # sliding window (tokens); -1 = full attention
    rope_theta: float = 10_000.0


@dataclass(frozen=True)
class ModelConfig:
    # identity ----------------------------------------------------------------
    name: str = "model"
    family: str = "dense"  # dense | moe | ssm | hybrid | vlm | audio
    source: str = ""  # citation for the config

    # trunk -------------------------------------------------------------------
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: Optional[int] = None  # default: d_model // num_heads
    d_ff: int = 1024
    vocab_size: int = 32_000
    act: str = "silu"
    norm_eps: float = 1e-6
    tie_embeddings: bool = True

    # attention ---------------------------------------------------------------
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    attn_logit_softcap: Optional[float] = None
    sliding_window: Optional[int] = None  # window for "local" layers
    global_every: Optional[int] = None  # 1 global layer per N (gemma3: 6)
    global_rope_theta: Optional[float] = None  # rope theta for global layers

    # MoE ---------------------------------------------------------------------
    num_experts: int = 0
    top_k: int = 0
    num_shared_experts: int = 0
    moe_d_ff: Optional[int] = None  # expert hidden dim (defaults to d_ff)
    moe_every: int = 1  # MoE ffn every N layers (others use dense mlp)
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    expert_pad_to: int = 16  # pad expert count to a multiple (EP divisibility)

    # SSM / hybrid ------------------------------------------------------------
    attn_every: Optional[int] = None  # hybrid: 1 attn layer per N (jamba: 8)
    ssm_state_dim: int = 16
    ssm_conv_dim: int = 4
    ssm_expand: int = 2
    ssm_chunk: int = 256  # time-chunk for the selective scan
    xlstm_pattern: Optional[tuple] = None  # e.g. ("mlstm", "slstm")

    # encoder-decoder ---------------------------------------------------------
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    encoder_seq_len: int = 3072  # frozen source length used for decode shapes

    # multimodal stub ---------------------------------------------------------
    modality: Optional[str] = None  # None | "audio" | "vision"

    # numerics ----------------------------------------------------------------
    # validated at construction against the precision subsystem's allowed
    # set (core/precision.py) so a bad dtype fails HERE, not deep inside
    # model init where the offending config is long out of the traceback
    param_dtype: str = "float32"
    compute_dtype: str = "float32"

    # execution ---------------------------------------------------------------
    # lax.scan over the layer stack (compact HLO, fast compile) vs unrolled
    # (exact cost_analysis: XLA counts while-loop bodies once — the dry-run
    # unrolls so roofline FLOPs/bytes/collectives are trip-count-true).
    scan_layers: bool = True
    remat: bool = True
    # "tp": heads/d_ff sharded over "model" (Megatron TP) — paper-faithful
    #       baseline for the dry-run.
    # "cp": sequence sharded over "model" (context parallel): MLP is fully
    #       local, attention all-gathers the (small, GQA) KV — §Perf it. 4.
    sharding_mode: str = "tp"
    # §Perf iteration 2 (EXPERIMENTS.md): saving MoE a2a results across the
    # remat boundary cuts wire traffic ~21% but costs ~2.7 GB/layer/device —
    # exceeds 16 GB HBM on the large MoE trains, so opt-in only.
    save_moe_a2a: bool = False
    # Explicit tensor parallelism (models/tensor_parallel.py, DESIGN.md §12):
    # tp_degree > 1 switches the two ROW-PARALLEL contractions (attention
    # out-projection over heads, MLP down-projection over d_ff) to the
    # blocked-canonical form — a stacked sum of tp_degree partial einsums.
    # Unsharded, this is the bitwise REFERENCE for a TP run of the same
    # degree: each TP rank computes exactly one of those partials and the
    # combine is the same stacked sum (for degree 2 a single f32 add, which
    # is order-independent by IEEE commutativity).  tp_degree=1 keeps the
    # historical single-einsum path untouched.
    tp_degree: int = 1

    # ------------------------------------------------------------------------
    def __post_init__(self):
        for f in ("param_dtype", "compute_dtype"):
            v = getattr(self, f)
            if v not in ALLOWED_DTYPES:
                raise ValueError(
                    f"{self.name}: {f}={v!r} is not a supported precision "
                    f"dtype; choose one of {ALLOWED_DTYPES} "
                    "(see core/precision.py)")
        t = self.tp_degree
        if t < 1:
            raise ValueError(f"{self.name}: tp_degree must be >= 1, got {t}")
        if t > 1:
            # only the dims the row/column split partitions need to divide
            for f, v in (("num_heads", self.num_heads),
                         ("num_kv_heads", self.num_kv_heads),
                         ("d_ff", self.d_ff)):
                if v and v % t:
                    raise ValueError(
                        f"{self.name}: tp_degree={t} does not divide "
                        f"{f}={v}")

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    @property
    def expert_d_ff(self) -> int:
        return self.moe_d_ff if self.moe_d_ff is not None else self.d_ff

    @property
    def num_experts_padded(self) -> int:
        """Experts padded up so the expert dim divides the EP axis (dummy
        experts hold zero weights and are never routed to)."""
        p = self.expert_pad_to
        return -(-self.num_experts // p) * p if self.num_experts else 0

    # ---- layer-stack structure ------------------------------------------------
    def superblock(self) -> tuple:
        """(specs, repeat): the decoder stack is ``specs`` repeated ``repeat``×."""
        n = self.num_layers
        if self.family == "ssm" and self.xlstm_pattern:
            pat = tuple(LayerSpec(mixer=m, ffn="none") for m in self.xlstm_pattern)
            assert n % len(pat) == 0, (self.name, n, pat)
            return pat, n // len(pat)
        if self.family == "hybrid" and self.attn_every:
            k = self.attn_every
            assert n % k == 0
            specs = []
            for i in range(k):
                mixer = "attn" if i == 0 else "mamba"
                ffn = "moe" if (self.num_experts and (i % self.moe_every == self.moe_every - 1)) else "mlp"
                specs.append(LayerSpec(mixer=mixer, ffn=ffn, rope_theta=self.rope_theta))
            return tuple(specs), n // k
        # uniform stacks (dense / moe / vlm / audio-decoder): superblock of 1.
        ffn = "moe" if self.num_experts else "mlp"
        specs = (LayerSpec(mixer="attn", ffn=ffn, rope_theta=self.rope_theta),)
        return specs, n

    def layer_windows(self):
        """Per-layer (window, rope_theta) for uniform attention stacks.

        Returns arrays of shape (repeat, len(superblock)) used as scanned
        values — this is how gemma3's 5:1 local:global pattern rides a
        homogeneous scan.
        """
        import numpy as np

        specs, repeat = self.superblock()
        s = len(specs)
        windows = np.full((repeat, s), FULL_ATTENTION, dtype=np.int32)
        thetas = np.full((repeat, s), self.rope_theta, dtype=np.float32)
        if self.sliding_window is not None:
            n = self.num_layers
            assert s == 1, "sliding-window patterns only supported on uniform stacks"
            for li in range(n):
                if self.global_every and (li + 1) % self.global_every == 0:
                    windows[li, 0] = FULL_ATTENTION
                    thetas[li, 0] = self.global_rope_theta or self.rope_theta
                else:
                    windows[li, 0] = self.sliding_window
                    thetas[li, 0] = self.rope_theta
        return windows, thetas

    def with_sliding_window(self, window: int = 4096) -> "ModelConfig":
        """Sliding-window *variant* for long-context decode on full-attention
        archs (see DESIGN.md §5 — explicitly flagged as a variant)."""
        return replace(self, sliding_window=window, global_every=None,
                       name=self.name + "-swa")

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: ≤2 super-blocks, d_model ≤ 512, ≤4 experts."""
        specs, _ = self.superblock()
        nl = len(specs) * min(2, max(1, self.num_layers // len(specs)))
        heads = min(self.num_heads, 4)
        kv = max(1, min(self.num_kv_heads, heads))
        while heads % kv:
            kv -= 1
        d_model = min(self.d_model, 256)
        return replace(
            self,
            name=self.name + "-reduced",
            num_layers=nl,
            d_model=d_model,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=min(self.resolved_head_dim, 64),
            d_ff=min(self.d_ff, 512) or 0,
            moe_d_ff=min(self.expert_d_ff, 256) if self.num_experts else None,
            vocab_size=min(self.vocab_size, 512),
            num_experts=min(self.num_experts, 4),
            expert_pad_to=1,
            top_k=min(self.top_k, 2),
            num_shared_experts=min(self.num_shared_experts, 1),
            num_encoder_layers=min(self.num_encoder_layers, 2),
            encoder_seq_len=min(self.encoder_seq_len, 64),
            sliding_window=min(self.sliding_window, 16) if self.sliding_window else None,
            global_every=2 if self.global_every else None,
        )

    # ---- parameter count -------------------------------------------------------
    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6·N·D)."""
        d, hd = self.d_model, self.resolved_head_dim
        qkv = d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd
        o = self.num_heads * hd * d
        attn = qkv + o + (self.num_heads * hd + 2 * self.num_kv_heads * hd if self.qkv_bias else 0)
        mlp = 3 * d * self.d_ff
        moe = 0
        if self.num_experts:
            moe = self.num_experts * 3 * d * self.expert_d_ff + d * self.num_experts
            moe += self.num_shared_experts * 3 * d * self.expert_d_ff
        d_in = self.ssm_expand * d
        mamba = (d * d_in * 2 + d_in * self.ssm_conv_dim + d_in * (self.ssm_state_dim * 2 + 1)
                 + d_in * self.ssm_state_dim + d_in + d_in * d)
        mlstm_d = (d * d_in * 2 + 3 * d_in + d_in * d)  # qkv from x, gates, out
        slstm_d = 4 * d * d + 4 * d * d + d * self.d_ff if self.d_ff else 8 * d * d

        specs, repeat = self.superblock()
        total = 0
        for spec in specs:
            if spec.mixer == "attn":
                total += attn
            elif spec.mixer == "mamba":
                total += mamba
            elif spec.mixer == "mlstm":
                total += mlstm_d
            elif spec.mixer == "slstm":
                total += slstm_d
            if spec.ffn == "mlp":
                total += mlp
            elif spec.ffn == "moe":
                total += moe
            total += 2 * d  # norms
        total *= repeat
        total += self.vocab_size * d  # embedding
        if not self.tie_embeddings:
            total += self.vocab_size * d
        total += d  # final norm
        if self.is_encoder_decoder:
            enc = self.num_encoder_layers * (attn + mlp + 2 * d)
            xattn = self.num_layers * (qkv + o + d)  # cross-attention per decoder layer
            total += enc + xattn
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top_k + shared experts count)."""
        if not self.num_experts:
            return self.param_count()
        full = self.param_count()
        d = self.d_model
        per_expert = 3 * d * self.expert_d_ff
        specs, repeat = self.superblock()
        n_moe_layers = sum(1 for s in specs if s.ffn == "moe") * repeat
        inactive = n_moe_layers * (self.num_experts - self.top_k) * per_expert
        return int(full - inactive)


# ---------------------------------------------------------------------------
_REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name.endswith("-swa"):
        return get_config(name[:-4]).with_sliding_window()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list:
    _ensure_loaded()
    return sorted(_REGISTRY)


_LOADED = False


def _ensure_loaded():
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    from repro_torch.configs import (deepseek_67b,  # noqa: F401
                                     gemma3_1b, granite_moe_1b,
                                     jamba_15_large, pixtral_12b, qwen2_15b,
                                     qwen2_moe_a27b, qwen25_14b,
                                     seamless_m4t_medium, xlstm_125m)
