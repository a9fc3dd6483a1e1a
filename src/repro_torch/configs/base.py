"""Config system for `repro_torch`: a copy of `repro.configs.base`, kept field
for field identical so the two packages cannot drift (a test compares them).

Every assigned architecture is described by a :class:`ModelConfig`. Input shapes are
described by :class:`ShapeConfig`. The training/serving distribution setup (mesh,
gradient-averaging mode per the paper) lives in :class:`RunConfig`.

All configs are plain frozen dataclasses: hashable (usable as dictionary keys),
serializable, and composable.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

# ---------------------------------------------------------------------------
# Model configs
# ---------------------------------------------------------------------------

BlockKind = str  # "attn" | "rglru" | "ssd"


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (MiniCPM3 / DeepSeek-V2 style)."""

    kv_lora_rank: int = 256
    q_lora_rank: int = 768
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 1
    num_shared_experts: int = 0
    # d_ff of each routed expert (shared experts use ModelConfig.d_ff)
    expert_d_ff: int = 0
    router_aux_loss_weight: float = 0.01
    # every `every` layers is MoE (1 = all layers)
    every: int = 1
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD parameters."""

    state_dim: int = 128
    head_dim: int = 64
    expand: int = 2
    chunk_size: int = 256
    conv_width: int = 4
    ngroups: int = 1


@dataclass(frozen=True)
class RGLRUConfig:
    """RecurrentGemma / Griffin recurrent block parameters."""

    lru_width: int = 0  # 0 -> d_model
    conv_width: int = 4
    # block pattern: indices i with i % pattern_period in attn_positions are local-attn
    pattern_period: int = 3
    attn_positions: Tuple[int, ...] = (2,)
    local_window: int = 2048


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    # attention flavor
    rope_theta: float = 10_000.0
    use_qk_norm: bool = False
    sliding_window: int = 0  # 0 = full attention
    # iRoPE-style chunked-local attention: layers with (i % global_every != global_offset)
    # use local chunks of `chunk_attn_window`; 0 disables.
    chunk_attn_window: int = 0
    global_attn_every: int = 4
    # ffn flavor: "swiglu" | "geglu" | "gelu"
    ffn: str = "swiglu"
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    tie_embeddings: bool = True
    # sub-configs
    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    # encoder-decoder (audio): number of encoder layers (decoder = num_layers)
    encoder_layers: int = 0
    # modality frontend stub: if set, inputs may be precomputed embeddings with
    # this feature dim (projected to d_model by a learned projector).
    frontend_embed_dim: int = 0
    # serve-time option: allocate sliding-window attention caches as W-slot
    # ring buffers instead of full seq_len (perf iteration, EXPERIMENTS.md §Perf)
    ring_buffer_cache: bool = False
    # citation / provenance
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    def block_kind(self, layer_idx: int) -> BlockKind:
        if self.family == "ssm":
            return "ssd"
        if self.rglru is not None:
            pat = self.rglru
            return "attn" if (layer_idx % pat.pattern_period) in pat.attn_positions else "rglru"
        return "attn"

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks), for roofline MODEL_FLOPS."""
        d, V = self.d_model, self.vocab_size
        emb = V * d if self.tie_embeddings else 2 * V * d
        total = emb
        hd = self.resolved_head_dim
        for i in range(self.num_layers + self.encoder_layers):
            kind = self.block_kind(i % max(self.num_layers, 1))
            if kind == "attn" or self.is_encdec:
                if self.mla is not None:
                    m = self.mla
                    attn = (
                        d * m.q_lora_rank
                        + m.q_lora_rank * self.num_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                        + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                        + m.kv_lora_rank * self.num_heads * (m.qk_nope_head_dim + m.v_head_dim)
                        + self.num_heads * m.v_head_dim * d
                    )
                else:
                    attn = d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd + self.num_heads * hd * d
            elif kind == "rglru":
                w = self.rglru.lru_width or d
                attn = 2 * d * w + 2 * w + w * d  # in/gate projections + lru params + out
            else:  # ssd
                s = self.ssm
                dinner = s.expand * d
                nheads = dinner // s.head_dim
                attn = d * (2 * dinner + 2 * s.ngroups * s.state_dim + nheads) + dinner * d
            if self.moe is not None and (i % self.moe.every == 0):
                eff = self.moe.expert_d_ff or self.d_ff
                ff_mults = 3 if self.ffn in ("swiglu", "geglu") else 2
                ffn = self.moe.num_experts * ff_mults * d * eff + self.moe.num_shared_experts * ff_mults * d * eff
                ffn += d * self.moe.num_experts  # router
            else:
                ff_mults = 3 if self.ffn in ("swiglu", "geglu") else 2
                ffn = ff_mults * d * self.d_ff
            total += attn + ffn + 2 * d  # + norms
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top_k + shared experts count)."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        eff = self.moe.expert_d_ff or self.d_ff
        ff_mults = 3 if self.ffn in ("swiglu", "geglu") else 2
        per_layer_all = self.moe.num_experts * ff_mults * d * eff
        per_layer_active = (self.moe.top_k) * ff_mults * d * eff
        n_moe_layers = sum(1 for i in range(self.num_layers) if i % self.moe.every == 0)
        return self.param_count() - n_moe_layers * (per_layer_all - per_layer_active)


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # "train" | "prefill" | "decode"


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


# ---------------------------------------------------------------------------
# Run (distribution + paper technique) config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AveragingConfig:
    """The paper's gradient-aggregation knob (Sections IV & V).

    mode:
      exact        -- AllReduce/psum over all data-parallel axes (DMB, Alg. 1)
      gossip       -- R rounds of doubly-stochastic consensus over the data axis
                      (D-SGD/AD-SGD, Algs. 3-4, eq. 17)
      hierarchical -- psum within pod, gossip across pods (TPU adaptation)
    """

    mode: str = "exact"
    rounds: int = 1  # R
    topology: str = "ring"  # ring | torus | circulant2 (deg-4 expander)
    self_weight: float = 0.0  # 0 -> uniform 1/(deg+1)
    quantization: str = "none"  # none | sign | int8 | int8_stoch
    # pack the gradient pytree into one flat [N, D] buffer per dtype so the
    # mixing operator runs once per step instead of once per leaf
    # (core.packing); per-leaf fallback when off. Quantized stats="global"
    # always takes the per-leaf oracle path (bit-identity contract).
    # Tri-state: "auto" (default) packs everywhere EXCEPT layouts whose
    # param leaves are actually sharded over a model axis — numeric parity
    # under a model split is test-covered, but the pack's relayout cost on a
    # real mesh is un-profiled (ROADMAP real-TPU debt), so those layouts opt
    # in explicitly with True. The trainer resolves this against its mesh
    # via `core.averaging.resolve_packed`; direct `core.averaging` callers
    # see "auto" as on (truthy).
    packed: Any = "auto"  # "auto" | True | False
    # quantizer statistic granularity: global (exact per-round oracle) |
    # segment (per-leaf scales on the packed buffer) | tile (fused kernel,
    # per-[N, quant_block_d]-tile scales computed in-register) | node
    # (sender-local per-[1, quant_block_d] row-tile scales — the only
    # granularity whose wire values survive a node-axis device split, so the
    # shard_map gossip kernels require it)
    quant_stats: str = "global"
    quant_block_d: int = 512
    # error-feedback compressed gossip, see
    # docs/DESIGN.md §Decentralized LM track: "off" | "grads". With
    # "grads", the compressor runs ONCE per
    # step on v = grad + residual (sender-local per-node tile statistics),
    # the R consensus rounds mix the compressed values with the exact LINEAR
    # operator (so the composed-roll / matmul / shard_map implementations
    # apply under compression), and the residual v - C(v) is carried per node
    # in `OptState.ef_residual` — compression error stays in optimizer state
    # instead of accumulating as iterate bias under momentum. Gossip mode
    # only.
    error_feedback: str = "off"


@dataclass(frozen=True)
class StreamConfig:
    """The paper's rate model (Section II-C)."""

    streaming_rate: float = 0.0  # R_s samples/s; 0 = no governor (consume everything)
    processing_rate: float = 0.0  # R_p samples/s/node
    comms_rate: float = 0.0  # R_c messages/s
    # If positive, force this many discarded samples per round (mu); otherwise planned.
    forced_mu: int = -1


@dataclass(frozen=True)
class GovernorConfig:
    """Closed-loop governor knobs beyond the per-round rate model: the
    adaptive-B bucket ladder and the online (R_p, R_c) estimator
    (docs/DESIGN.md §Adaptive batch buckets).

    The network mini-batch B may only move between *registered* buckets —
    each one a multiple of N with a pre-compiled superstep — so a re-plan
    costs a plan swap, never a retrace. `n_buckets=1` with no explicit
    `buckets` pins B (the pre-ladder governor: only mu adapts).
    """

    # explicit B ladder (each a multiple of the node count); () -> auto
    buckets: Tuple[int, ...] = ()
    # auto-ladder size around the planned B when `buckets` is not given
    n_buckets: int = 1
    bucket_factor: int = 2  # geometric spacing of the auto ladder
    # consecutive re-plans that must agree on a new bucket before the switch
    # (timing jitter must not thrash the ladder)
    hysteresis: int = 2
    # fit (R_p, R_c) online by least squares over observed (B, round-time)
    # pairs instead of trusting the config's comms_rate when inverting eq. 4
    estimate_rates: bool = True
    window: int = 64  # estimator observation window (supersteps)

    # --- elastic membership (docs/DESIGN.md §Elastic membership) ---
    # straggler policy over per-node round times: "wait" (lockstep, never
    # drop — the paper's assumption), "drop" (exclude nodes slower than
    # straggler_slow_factor x the active-cohort median), "deadline" (exclude
    # nodes slower than the absolute straggler_deadline_s)
    straggler_policy: str = "wait"
    straggler_slow_factor: float = 2.0
    straggler_deadline_s: float = 0.0
    # consecutive verdicts before a node is dropped or readmitted (per-node
    # BucketHysteresis — same debounce discipline as bucket switches)
    straggler_patience: int = 2
    # on rejoin, overwrite the returning node's rows with the active-cohort
    # mean so its stale iterate cannot blow up the consensus error
    sync_on_rejoin: bool = True


@dataclass(frozen=True)
class ScenarioConfig:
    """One named cell of the scenario harness (`core/scenarios.py`;
    docs/DESIGN.md §Scenario harness): a seeded, deterministic composition of
    the three orthogonal axes the paper's assumptions quantify over —

    * **topology schedule**: the time-varying mixing graph of eq. 17, as
      (topology, rounds) segments cycled by the consensus round counter.
      Topologies: ring | torus | circulant2 | expander | geometric.
    * **link model**: per-edge loss/bandwidth faults in the extended
      `core.faults.FaultSchedule` DSL ('link:1-2@4-20p0.1,bw:0-3@5-15x4');
      empty = loss-free links. Link windows index consensus rounds.
    * **stream**: the per-node data distribution — iid_pca | drift_pca |
      iid_logreg | skew_logreg, with `stream_param` the drift rate
      (radians/sample) or the Dirichlet concentration alpha.

    Pure data (hashable, serializable); `core.scenarios` owns construction of
    the operators, samplers, and fault schedules it names."""

    name: str
    n_nodes: int = 8
    rounds: int = 2  # R consensus rounds per algorithm step
    # ((topology, n_rounds), ...): consecutive segments of the cyclic schedule
    topology_schedule: Tuple[Tuple[str, int], ...] = (("ring", 1),)
    links: str = ""  # FaultSchedule DSL, link:/bw: tokens only
    stream: str = "iid_pca"
    stream_param: float = 0.0
    seed: int = 0
    self_weight: float = 0.0  # circulant self-weight (0 -> uniform)
    # link-loss realization horizon in rounds (0 -> auto: cover the link
    # windows and the topology period; realizations repeat beyond it)
    period_rounds: int = 0


@dataclass(frozen=True)
class PublishConfig:
    """Train-to-serve snapshot publication knobs
    (`serve/publisher.py`; docs/DESIGN.md §Train-to-serve publication).

    The publisher snapshots the consensus iterate at superstep boundaries
    into double-buffered device-resident copies with a monotone version
    counter; `overhead_budget` caps the fraction of training wall time its
    own governor lets publication consume."""

    enabled: bool = False
    overhead_budget: float = 0.05  # publish cost / train wall-time ceiling
    min_interval_s: float = 0.0  # floor between publishes (0 = budget only)
    block: bool = False  # block on the copy (deterministic tests/benchmarks)


@dataclass(frozen=True)
class SnapshotConfig:
    """Fault-tolerance knobs for the async checkpoint subsystem
    (`train/snapshot.py`; docs/DESIGN.md §Fault-tolerant streaming).

    The snapshotter captures the full run state (TrainState + governor +
    splitter + membership + publisher version) at superstep boundaries and
    writes it from a background thread; `overhead_budget` caps the smoothed
    training-thread dispatch cost as a fraction of wall time between
    snapshots, mirroring the publisher's governor."""

    enabled: bool = False
    root: str = ""  # checkpoint directory (step_NNNNNNNN/ subdirs)
    every: int = 1  # superstep cadence between snapshot attempts
    keep_last: int = 3  # retention depth (newest-valid fallback on restore)
    overhead_budget: float = 0.05  # snapshot cost / train wall-time ceiling
    retries: int = 3  # leaf-write retry-with-backoff attempts in the writer
    backoff_s: float = 0.05
    block: bool = False  # wait for durability (deterministic tests only)


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    shape: ShapeConfig
    averaging: AveragingConfig = field(default_factory=AveragingConfig)
    stream: StreamConfig = field(default_factory=StreamConfig)
    # mesh
    multi_pod: bool = False
    # optimizer
    optimizer: str = "adam"  # sgd | adam | accel (paper eqs. 9-11)
    learning_rate: float = 3e-4
    weight_decay: float = 0.0
    polyak: bool = False  # Polyak-Ruppert iterate averaging (eq. 7)
    # numerics
    param_dtype: str = "bfloat16"
    # fp32 master weights for mixed precision (ZeRO-sharded); without them,
    # sub-bf16-resolution updates vanish
    master_weights: bool = True
    remat: bool = True
    # sequential microbatches per step (gradient accumulation): the paper's
    # compute-limited regime knob — the local mini-batch B/N is processed in
    # `microbatches` sequential slices per round
    microbatches: int = 1
    seed: int = 0


def reduced(cfg: ModelConfig, layers: int = 2, d_model: int = 256, experts: int = 4) -> ModelConfig:
    """A smoke-test-sized member of the same architecture family (brief: 2 layers,
    d_model<=512, <=4 experts)."""
    num_heads = max(2, min(cfg.num_heads, d_model // 64))
    ratio = max(1, cfg.num_heads // max(cfg.num_kv_heads, 1))
    num_kv = max(1, num_heads // ratio)
    changes = dict(
        num_layers=layers,
        d_model=d_model,
        num_heads=num_heads,
        num_kv_heads=num_kv,
        d_ff=2 * d_model,
        vocab_size=512,
        head_dim=64 if cfg.head_dim else 0,
    )
    if cfg.mla is not None:
        changes["mla"] = MLAConfig(kv_lora_rank=64, q_lora_rank=128, qk_nope_head_dim=32,
                                   qk_rope_head_dim=16, v_head_dim=32)
    if cfg.moe is not None:
        changes["moe"] = dataclasses.replace(
            cfg.moe, num_experts=min(experts, cfg.moe.num_experts),
            top_k=min(cfg.moe.top_k, min(experts, cfg.moe.num_experts)),
            num_shared_experts=min(1, cfg.moe.num_shared_experts),
            expert_d_ff=(2 * d_model if cfg.moe.expert_d_ff else 0))
    if cfg.ssm is not None:
        changes["ssm"] = dataclasses.replace(cfg.ssm, state_dim=32, head_dim=32, chunk_size=64)
    if cfg.rglru is not None:
        changes["rglru"] = dataclasses.replace(cfg.rglru, lru_width=0, local_window=128)
    if cfg.encoder_layers:
        changes["encoder_layers"] = layers
    if cfg.sliding_window:
        changes["sliding_window"] = 128
    if cfg.chunk_attn_window:
        changes["chunk_attn_window"] = 128
    if cfg.frontend_embed_dim:
        changes["frontend_embed_dim"] = 128
    return dataclasses.replace(cfg, **changes)
