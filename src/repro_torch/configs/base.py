"""Config system: model / parallelism / training / serving dataclasses.

Every assigned architecture is one ``configs/<id>.py`` exporting
``CONFIG``; ``configs.get_config(name)`` resolves them, and every config
supports ``cfg.replace(...)`` overrides plus ``key=value`` CLI override
strings via :func:`apply_overrides`.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any

FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    qkv_bias: bool = False
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_chunk: int = 256
    # hybrid (zamba2-style shared attention)
    attn_every: int = 0            # 0 = pure; else shared attn period
    # per-layer attention-mask pattern (Mistral/Gemma-style interleaving):
    # mask-spec strings ("causal" | "full" | "swa:W" | "chunked:C"),
    # cycled over the layer stack.  Empty = every layer uses the run-wide
    # mask (ParallelConfig.attn_mask / --attn-mask).  Each distinct mask
    # gets its own FCP schedule (per-layer-group scheduling).
    attn_mask_pattern: tuple = ()
    # multimodal frontend stub
    frontend: str | None = None    # "encodec" | "vit"
    frontend_dim: int = 0          # precomputed embedding width
    # numerics
    param_dtype: str = "bfloat16"
    max_seq_len: int = 524288

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---- mesh-dependent padding (DESIGN.md §5) -----------------------------
    def padded_heads(self, tp: int) -> tuple[int, int]:
        """(n_heads, n_kv_heads) padded so both divide ``tp``.

        KV heads are replicated up when fewer than tp (standard GQA-TP
        practice); query heads zero-padded.  Numerically exact: padded
        projections are zero so padded heads contribute nothing.
        """
        def up(x, m):
            return ((x + m - 1) // m) * m
        nh = up(self.n_heads, tp)
        nkv = up(self.n_kv_heads, tp) if self.n_kv_heads % tp else \
            self.n_kv_heads
        if nkv < tp:
            nkv = tp
        # keep group structure: nh must be a multiple of nkv
        if nh % nkv:
            nh = up(nh, nkv)
        return nh, nkv

    def padded_vocab(self, tp: int) -> int:
        return ((self.vocab_size + tp - 1) // tp) * tp

    def padded_ssm_heads(self, tp: int) -> int:
        nheads = (self.ssm_expand * self.d_model) // self.ssm_head_dim
        return ((nheads + tp - 1) // tp) * tp

    @property
    def uses_attention(self) -> bool:
        return self.family != "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (SSM / hybrid backbones)."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Approximate parameter count N (for 6·N·D MODEL_FLOPS)."""
        d, L, V = self.d_model, self.n_layers, self.vocab_size
        emb = V * d * (1 if self.tie_embeddings else 2)
        if self.family in ("dense", "moe", "audio", "vlm"):
            attn = d * (self.n_heads + 2 * self.n_kv_heads) * self.head_dim \
                + self.n_heads * self.head_dim * d
            if self.n_experts:
                ffn = 3 * d * self.d_ff * self.n_experts + d * self.n_experts
            else:
                ffn = 3 * d * self.d_ff
            return emb + L * (attn + ffn + 2 * d)
        if self.family == "ssm":
            din = self.ssm_expand * d
            nheads = din // self.ssm_head_dim
            inproj = d * (2 * din + 2 * self.ssm_state + nheads)
            return emb + L * (inproj + din * d + 2 * d)
        if self.family == "hybrid":
            din = self.ssm_expand * d
            nheads = din // self.ssm_head_dim
            mamba = d * (2 * din + 2 * self.ssm_state + nheads) + din * d
            shared = d * (self.n_heads + 2 * self.n_kv_heads) * self.head_dim \
                + self.n_heads * self.head_dim * d + 3 * d * self.d_ff
            return emb + L * (mamba + 2 * d) + shared
        raise ValueError(self.family)

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: top-k experts only)."""
        if not self.n_experts:
            return self.param_count()
        dense_like = self.replace(n_experts=0, experts_per_token=0)
        base = dense_like.param_count() - 3 * self.n_layers * \
            self.d_model * self.d_ff
        return base + 3 * self.n_layers * self.d_model * self.d_ff \
            * self.experts_per_token


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    fsdp: bool = True              # shard weights/opt over the data axis
    cp_axis: str = "data"
    tp_axis: str = "model"
    dp_axis: str = "pod"
    block_size: int = 4096        # FCP scheduling block (paper: 4K)
    coalesce: int = 16
    remat: bool = True
    remat_policy: str = "dots"    # "dots" | "nothing" (§Perf #2)
    # executor attention impl: per-step ("xla" | "pallas") or one fused
    # launch per run ("fused_xla" | "fused" — the latter is the
    # schedule-table-driven Pallas kernel, "fused_xla" its CPU fallback)
    attention_impl: str = "xla"
    attn_block_q: int = 256       # fused/pallas kernel q tile
    attn_block_k: int = 256       # fused/pallas kernel kv tile
    attn_interpret: bool = False  # pallas interpret mode (CPU testing)
    # run-wide attention-mask family ("causal" | "full" | "swa:W" |
    # "chunked:C"); models with a per-layer attn_mask_pattern override it
    attn_mask: str = "causal"
    # wire format of every FCP ppermute payload ("f32" passthrough |
    # "bf16" | "int8" with per-(block, head) scales; runtime/wire.py).
    # Folded into StaticSpec and every plan-cache key, and preserved
    # across elastic replans like the other schedule knobs.
    comm_dtype: str = "f32"
    # itemsize of the compute dtype the payloads ship in UNENCODED (the
    # train driver sets it from ModelConfig.param_dtype): prices the
    # wire's byte-aware planning in real bytes — under bf16 compute
    # (2) the bf16 wire is a no-op while int8 still halves traffic.
    # Rides ParallelConfig so elastic replans reprice identically and
    # re-hit the train pipeline's plan-cache entries.
    in_dtype_bytes: float = 4.0
    locality: str = "auto"        # affinity-aware LPT: "auto" | on | off
    chunked_loss: bool = False    # CE without full logits (§Perf #3)
    attn_out_bf16: bool = False   # executor restores o in bf16 (§Perf #4)
    # amortized planning (core/plan_cache.py): canonical length buckets
    # per doubling (0 = raw lengths), LRU schedule-cache capacity, and
    # whether batch t+1 is planned on a host thread while t executes.
    # Elastic replans must preserve all three (runtime/elastic.replan).
    plan_buckets: int = 0
    plan_cache_size: int = 64
    plan_ahead: bool = True
    # runtime health telemetry (runtime/health.py), consumed by the
    # supervised train loop: consecutive straggler observations before
    # a demotion replan fires (hysteresis), the relative speed below
    # which a worker counts as a straggler, the heartbeat timeout (s)
    # that declares a worker lost, and the minimum steps between
    # demote/promote events (rate limit — with speed quantization this
    # bounds how fast oscillating measurements can change plan keys).
    # checkpoint_every is the periodic-checkpoint cadence that bounds
    # step loss on recovery.  All ride ParallelConfig so elastic
    # replans preserve them like every other knob.
    health_window: int = 8
    straggler_threshold: float = 0.8
    step_timeout: float = 60.0
    demote_cooldown: int = 16
    checkpoint_every: int = 10
    # software-pipelined executor rounds (docs/overlap.md): issue round
    # r+1's sends before run r's compute and double-buffer the receive
    # slots.  Folded into StaticSpec and every plan-cache key (parity
    # bit), and preserved across elastic replans like the other
    # schedule knobs.
    overlap: bool = False
    # layer-pipelined reshuffle: keep the hidden state resident in the
    # schedule layout across each run of same-mask layers, moving it
    # once per layer-group boundary (executor.fcp_reshuffle) instead of
    # reshuffling Q/K/V and restoring O in every layer.  Model-level
    # transform only — schedules and plan keys are unchanged.
    layer_pipeline: bool = False


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Continuous-batching serving knobs (``runtime/serving.py``).

    The serving loop admits requests into a bounded queue, prefills
    prompts through FCP in length-bucketed uniform batches (every batch
    re-hits the plan cache), and decodes on a fixed pool of batch slots
    against the sequence-sharded cache.  All static shapes the loop
    compiles against come from here, so a fixed ``ServeConfig`` means a
    fixed, warmup-bounded set of XLA compilations.
    """
    cache_len: int = 512           # decode KV/state cache length per slot
    decode_slots: int = 8          # continuous-batching decode batch size
    queue_depth: int = 64          # admission-controlled queue bound
    max_new_tokens: int = 32       # per-request generation cap
    # prefill batch geometry: one FCP composition of
    # ``n_cp * prefill_tokens_per_worker`` tokens, cut into
    # ``budget / bucket`` sequences of one bucket edge each.  Edges run
    # geometrically from ``bucket_min`` up to the budget (divisor edges
    # only), so the plan-key space is tiny and every mixed-length
    # stream collapses onto it.
    prefill_tokens_per_worker: int = 512
    bucket_min: int = 64           # smallest prefill bucket edge
    prefill_impl: str = "fcp"      # "fcp" | "dense" (escape hatch)
    kind: str = "decode"           # decode cache layout ("decode"|"long")
    # FCP prefill does not span the pod axis yet: on a pod mesh the
    # loop falls back to dense prefill with a warning.  strict mode
    # turns that degradation into the old hard error (deployments that
    # would rather crash than silently serve slower).
    strict_prefill: bool = False

    def replace(self, **kw) -> "ServeConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    seq_len: int = 4096
    global_batch: int = 256
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    b1: float = 0.9
    b2: float = 0.95
    grad_compression: bool = False   # bf16 error-feedback DP all-reduce
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

ARCH_NAMES = [
    "stablelm_1_6b", "codeqwen1_5_7b", "qwen1_5_110b", "qwen1_5_32b",
    "moonshot_v1_16b_a3b", "granite_moe_3b_a800m", "musicgen_large",
    "internvl2_1b", "mamba2_130m", "zamba2_2_7b",
]


def get_config(name: str) -> ModelConfig:
    mod = importlib.import_module(
        f"repro_torch.configs.{name.replace('-', '_')}")
    return mod.CONFIG


def smoke_config(name: str) -> ModelConfig:
    mod = importlib.import_module(
        f"repro_torch.configs.{name.replace('-', '_')}")
    return mod.SMOKE


def apply_overrides(cfg: Any, overrides: list[str]) -> Any:
    """Apply ``key=value`` CLI override strings to a (frozen) dataclass."""
    kw = {}
    for ov in overrides:
        k, v = ov.split("=", 1)
        cur = getattr(cfg, k)
        if isinstance(cur, bool):
            kw[k] = v.lower() in ("1", "true", "yes")
        elif isinstance(cur, int):
            kw[k] = int(v)
        elif isinstance(cur, float):
            kw[k] = float(v)
        else:
            kw[k] = v
    return dataclasses.replace(cfg, **kw)
