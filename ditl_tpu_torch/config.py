"""Configuration for the PyTorch port.

Copies of ``ModelConfig``, ``DataConfig`` and ``TrainConfig`` from the JAX
package's ``config.py``, cut to the fields the port reads (``APIConfig`` and
``TelemetryConfig`` whole, with the latter's validation and helpers), with the same
names, types and defaults, so a preset or an override means the same run in
both packages. The port never imports the JAX package, so it keeps its own
copies (``tests/test_torch_imports.py`` holds them to the originals field for
field). ``Config`` groups the three sections the training launcher reads and
``parse_overrides`` applies ``section.field=value`` overrides as the JAX
launcher does.

Fields whose features are not ported yet are kept so that setting them
raises where the JAX package would act on them: MoE, LoRA and int8 caches in
the model code; multi-step calls, HF import, the training event journal,
profiling, the fault drills and incident bundles here, at construction. The backward kernels
of the MLP block and of the attention projections (``mlp_bwd_impl``,
``mlp_custom_vjp``, ``proj_bwd_impl`` and their block fields) are validated
as the JAX package validates them.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field, fields, replace
from typing import Any, Sequence

__all__ = ["ModelConfig", "DataConfig", "TrainConfig", "APIConfig", "TelemetryConfig",
           "Config",
           "parse_model_overrides", "parse_overrides"]

# attention_impl values the port runs; the others wait for later slices.
PORTED_ATTENTION_IMPLS = ("xla", "flash")
REMAT_POLICIES = ("none", "full", "dots", "dots_inputs", "attn")
_NOT_PORTED = " is not ported to PyTorch yet (see ROADMAP.md)"


@dataclass(frozen=True)
class ModelConfig:
    """Llama-family architecture hyperparameters (defaults describe a tiny
    debug model; ``models/presets.py`` holds the published shapes)."""

    name: str = "tiny-llama"
    vocab_size: int = 32000
    hidden_size: int = 256
    intermediate_size: int = 688
    num_layers: int = 4
    num_heads: int = 8
    num_kv_heads: int = 4
    head_dim: int = 32
    max_seq_len: int = 2048
    rope_theta: float = 500000.0
    # Llama-3.1 "llama3" RoPE scaling; factor 0 disables.
    rope_scaling_factor: float = 0.0
    rope_scaling_low_freq_factor: float = 1.0
    rope_scaling_high_freq_factor: float = 4.0
    rope_scaling_original_max_len: int = 8192
    rms_norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # Qwen2-style bias on the q/k/v projections.
    attention_bias: bool = False
    dtype: str = "bfloat16"  # compute dtype (serving also stores weights in it)
    param_dtype: str = "float32"  # training masters' dtype
    num_experts: int = 0  # MoE: > 0 raises (not ported)
    lora_rank: int = 0  # LoRA: > 0 raises (not ported)
    # "xla" (plain PyTorch attention) | "flash" (the hand-written CUDA
    # kernels, ops/flash_attention.py: K1 forward, K2a/K2b backward).
    attention_impl: str = "xla"
    kv_cache_dtype: str = ""  # "" / "model" (the compute dtype) or "int8"
    # Rematerialization of the training forward (models/llama.py): "none" |
    # "full" (each decoder layer under torch.utils.checkpoint) | "dots" (keep
    # the weight products) | "dots_inputs" (those plus the tagged attn_in and
    # mlp_in) | "attn" (keep only the tagged attn_out).
    remat: str = "full"
    fused_gate_up: bool = False  # gate|up stored as one (D, 2F) matrix
    fused_qkv: bool = False  # q|k|v stored as one (D, (H + 2K) * hd) matrix
    # Hand-written VJP for the fused-gate|up MLP block (ops/mlp.py; needs
    # fused_gate_up): the block's backward as one function, einsum spelling.
    mlp_custom_vjp: bool = False
    # MLP backward behind that seam: "xla" (the einsum spelling) | "pallas"
    # (the hand-written CUDA kernels K5a/K5b, ops/mlp_bwd.py; needs
    # fused_gate_up and routes through the seam even when mlp_custom_vjp is
    # off). Shapes ops/mlp_bwd.supports rejects take the einsum spelling.
    mlp_bwd_impl: str = "xla"
    # The reference's Pallas tile sizes (0 = its defaults). They decide which
    # shapes ops/mlp_bwd.supports admits, as in the reference; the CUDA
    # kernels' tiles are their own constants.
    mlp_bwd_block_n: int = 0
    mlp_bwd_block_f: int = 0
    mlp_bwd_block_d: int = 0
    # Attention-projection backward: "xla" | "pallas" (the hand-written CUDA
    # kernel K6, ops/projection.py: dx and dw from one launch).
    proj_bwd_impl: str = "xla"
    proj_bwd_block_n: int = 0
    proj_bwd_block_d: int = 0
    # Loss head: "naive" materializes (B, S, V) f32 logits; "fused" computes
    # the lm head + cross-entropy blockwise (ops/fused_ce.py).
    loss_impl: str = "naive"
    loss_block_tokens: int = 1024

    def __post_init__(self):
        # The reference's checks first, in its order and with its errors.
        if self.num_experts > 0 and (
            self.fused_gate_up or self.mlp_custom_vjp
            or self.mlp_bwd_impl != "xla"
        ):
            raise ValueError(
                "fused_gate_up/mlp_custom_vjp/mlp_bwd_impl target the dense "
                f"MLP path and do not apply to MoE models (num_experts="
                f"{self.num_experts}); unset them rather than measuring a "
                "silently unfused program"
            )
        if self.attention_impl not in PORTED_ATTENTION_IMPLS:
            raise ValueError(
                f"attention_impl {self.attention_impl!r} is not ported to "
                f"PyTorch yet (ported: {', '.join(PORTED_ATTENTION_IMPLS)}); "
                "see ROADMAP.md for the slice that brings it"
            )
        if self.remat not in REMAT_POLICIES:
            raise ValueError(f"unknown remat policy {self.remat!r} "
                             f"({'|'.join(REMAT_POLICIES)})")
        for knob, allowed in (("mlp_bwd_impl", ("xla", "pallas")),
                              ("proj_bwd_impl", ("xla", "pallas")),
                              ("loss_impl", ("naive", "fused"))):
            if getattr(self, knob) not in allowed:
                raise ValueError(f"unknown {knob} {getattr(self, knob)!r} "
                                 f"({'|'.join(allowed)})")
        for blk in ("mlp_bwd_block_n", "mlp_bwd_block_f", "mlp_bwd_block_d",
                    "proj_bwd_block_n", "proj_bwd_block_d"):
            if getattr(self, blk) < 0:
                raise ValueError(f"{blk} must be >= 0 (0 = kernel default), "
                                 f"got {getattr(self, blk)}")
        if self.mlp_bwd_impl == "pallas" and not self.fused_gate_up:
            raise ValueError(
                "mlp_bwd_impl='pallas' requires fused_gate_up=True (the "
                "kernels target the fused w_gu layout)"
            )
        if self.loss_block_tokens < 1:
            raise ValueError("loss_block_tokens must be >= 1")


@dataclass(frozen=True)
class DataConfig:
    """Data pipeline (the JAX package's ``DataConfig``, every field)."""

    dataset_name: str = "imdb"
    dataset_split: str = "train[:1%]"
    text_column: str = "text"
    label_column: str = "label"
    batch_size: int = 4  # global batch size
    seq_len: int = 512
    shuffle: bool = True
    seed: int = 0
    drop_last: bool = False
    # Fraction of the dataset held out for validation (train.val_every; the
    # two are set together); 0 disables. A seeded permutation, then the tail.
    eval_fraction: float = 0.0
    num_epochs: int = 3
    tokenizer: str = "byte"  # "byte" | HF tokenizer name (raises)
    pack_sequences: bool = True
    prefetch: int = 2  # batches the producer thread keeps ready
    synthetic: bool = False  # True => generated data, no HF hub
    synthetic_examples: int = 256
    # Max seconds the step loop may wait for one batch: > 0 raises (the
    # data-wait timeout is not ported; the port waits).
    data_wait_timeout_s: float = 0.0

    def __post_init__(self):
        if self.data_wait_timeout_s > 0:
            raise NotImplementedError("data.data_wait_timeout_s" + _NOT_PORTED)


@dataclass(frozen=True)
class TrainConfig:
    """Training loop (the JAX package's ``TrainConfig``, cut to the fields
    the port reads or rejects)."""

    # "adamw" | "adafactor"; "lion" and "sgd" raise (not ported).
    optimizer: str = "adamw"
    learning_rate: float = 3e-4
    warmup_steps: int = 10
    total_steps: int = 100
    weight_decay: float = 0.01
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip_norm: float = 1.0
    grad_accum_steps: int = 1
    adam_mu_dtype: str = "float32"  # Adam first-moment storage dtype
    steps_per_call: int = 1  # > 1 raises (multi-step calls not ported)
    log_every: int = 10
    metrics_file: str = ""  # "" => no JSONL scalar stream
    eval_every: int = 0  # 0 => no API eval loop (client/eval_loop.py)
    eval_samples: int = 8
    # Local validation: every N steps the eval step runs over val_batches
    # batches of the held-out split (data.eval_fraction).
    val_every: int = 0
    val_batches: int = 8
    checkpoint_dir: str = ""  # "" => checkpointing disabled (train/checkpoint.py)
    checkpoint_every: int = 0
    keep_checkpoints: int = 3
    resume: bool = True  # resume from the latest checkpoint if present
    # Fault drills: non-zero raises (not ported).
    fault_inject_step: int = 0
    fault_kill_step: int = 0
    fault_nan_step: int = 0
    telemetry_dir: str = ""  # set raises (event journal not ported)
    init_from_hf: str = ""  # set raises (HF import not ported)
    seed: int = 42
    profile_dir: str = ""  # set raises (profiling not ported)

    def __post_init__(self):
        unported = {
            "init_from_hf": "HF checkpoint import",
            "telemetry_dir": "the event journal", "profile_dir": "profiling",
            "fault_inject_step": "the fault drills",
            "fault_kill_step": "the fault drills",
            "fault_nan_step": "the fault drills",
        }
        for name, what in unported.items():
            if getattr(self, name):
                raise NotImplementedError(f"train.{name} ({what})" + _NOT_PORTED)
        if self.steps_per_call > 1:
            raise NotImplementedError(
                "train.steps_per_call > 1 (multi-step calls)" + _NOT_PORTED)
        if self.optimizer not in ("adamw", "adafactor", "lion", "sgd"):
            raise ValueError(f"unknown optimizer {self.optimizer!r} "
                             "(adamw|adafactor|lion|sgd)")
        if self.grad_accum_steps < 1:
            raise ValueError("grad_accum_steps must be >= 1")


@dataclass(frozen=True)
class APIConfig:
    """Remote-LLM (OpenAI-compatible) client config (the JAX package's
    ``APIConfig``, every field). The API key is never stored here;
    ``api_key()`` reads the environment at call time."""

    model_name: str = "meta-llama/Meta-Llama-3.1-70B-Instruct"
    api_base: str = "http://localhost:4000/v1"
    api_key_env: str = "OPENAI_API_KEY"
    timeout_s: float = 60.0
    max_retries: int = 5
    backoff_base_s: float = 0.5  # exponential backoff with jitter
    backoff_max_s: float = 30.0
    # Hard wall-clock bound over the whole retry loop of one logical call:
    # per-attempt timeouts are clamped to the remaining budget and backoff
    # never sleeps past the deadline. 0 = unbounded.
    total_timeout_s: float = 0.0
    max_concurrency: int = 8  # complete_many's fan-out

    def api_key(self) -> str:
        return os.environ.get(self.api_key_env, "")


@dataclass(frozen=True)
class TelemetryConfig:
    """Observability knobs shared by the serving and training legs
    (``telemetry/``): journal size control, and the SLO
    objectives the ``/slo`` burn-rate endpoints grade against. Latency
    thresholds snap DOWN to the histogram bucket ladders
    (telemetry/registry.py) — the effective bound is reported in the
    ``/slo`` body so nobody grades against a number that was silently
    rounded."""

    # Per-process JSONL journal rotation cap in MiB (0 = unbounded, the
    # historical behavior). With tracing armed, span records arrive per
    # request and tick instants per scheduler tick — a long serving run
    # must not grow its journal without bound. Total footprint stays
    # ~this cap (telemetry/journal.py keeps the newest segments only).
    journal_max_mb: float = 0.0
    # HBM accounting (telemetry/memwatch.py): sample per-device
    # allocator stats whenever the step counter crosses a multiple of N
    # (host-only reads, zero device syncs; with steps_per_call > 1 that is
    # at most once per window; 0 disables sampling). Backends without
    # memory_stats (CPU) degrade to no gauges, never a crash.
    memory_sample_every: int = 1
    # How many live buffers the OOM post-mortem dump records
    # (shape/dtype/sharding/nbytes, largest first).
    memory_topk: int = 8
    # Server (replica) SLOs: TTFT / TPOT latency objectives over the
    # engine's harvest-observed histograms, plus availability.
    slo_ttft_s: float = 2.5
    slo_ttft_target: float = 0.95
    slo_tpot_s: float = 0.25
    slo_tpot_target: float = 0.95
    slo_availability_target: float = 0.999
    # Gateway SLOs: end-to-end relay latency + fleet availability.
    slo_gateway_e2e_s: float = 10.0
    slo_gateway_e2e_target: float = 0.95
    # Multi-window burn-rate evaluation: the alert fires only when BOTH
    # windows burn the error budget faster than slo_burn_alert (fast window
    # for responsiveness, slow window to de-flap).
    slo_fast_window_s: float = 300.0
    slo_slow_window_s: float = 3600.0
    slo_burn_alert: float = 1.0
    # -- Flight recorder + anomaly plane ---------------------------------
    # Rows each always-on flight ring keeps (telemetry/flight.py): the
    # black-box horizon an incident bundle dumps. Bounded memory; zero
    # device syncs; dumped only on trigger.
    flight_ring_size: int = 512
    # Incident bundle directory (telemetry/incident.py); "" = anomaly
    # detectors may still run (journaled anomaly.detected events) but no
    # bundles are assembled.
    incident_dir: str = ""  # set raises (the incident plane is not ported)
    # Fingerprint cooldown: triggers for the same anomaly fingerprint
    # within this window only bump the suppressed counter — a sustained
    # storm is ONE bundle.
    incident_cooldown_s: float = 300.0
    # Bundle-dir retention (oldest-first GC, journal-rotation spirit).
    incident_max_bundles: int = 16
    incident_max_mb: float = 64.0
    # Bundle contents: last-N merged journal events, and the trace-slice
    # half-window (seconds before the trigger) exported to Chrome-trace.
    incident_journal_tail: int = 200
    incident_trace_window_s: float = 30.0
    # Serving detectors (telemetry/anomaly.py): observe cadence in
    # scheduler ticks, per-window storm threshold (deadline expiries /
    # 429s / preemptions / gateway spills), queue-depth growth limit,
    # latency-jump factor vs the rolling windowed-p95 baseline (with a
    # minimum sample count), and the prefix-hit-ratio collapse floor.
    anomaly_check_every_ticks: int = 32
    anomaly_storm_threshold: int = 8
    anomaly_queue_depth: int = 64
    anomaly_latency_factor: float = 3.0
    anomaly_min_samples: int = 16
    anomaly_hit_ratio_floor: float = 0.5
    # Training detectors: rolling window length, spike factor over the
    # rolling loss median, explosion factor over the rolling grad-norm
    # median (non-finite loss/grad always fires — not a knob).
    anomaly_window: int = 32
    anomaly_loss_spike_factor: float = 4.0
    anomaly_grad_explosion_factor: float = 10.0
    # -- Continuous profiling & stall attribution ------------------------
    # Wall-clock sampling profiler hertz (telemetry/prof.py): 0 disarms;
    # > 0 arms a continuous sampler across the trainer's step loop and on
    # a profiling-armed gateway (the bench A/B leg gates its overhead
    # inside the perf_compare noise floor, so leaving it on is priced).
    prof_hz: float = 0.0
    # Distinct collapsed stacks the sampler holds before oldest-first
    # eviction — the profiler's hard memory cap.
    prof_max_stacks: int = 2048
    # Event-loop lag watchdog (evloop data plane only): busy heartbeat
    # age past this threshold is a stall — burst-sampled into a
    # convicting stack, journaled as loop.stall, and fed to the incident
    # plane. 0 disarms the watchdog.
    loop_stall_threshold_s: float = 0.0
    # Burst-sampling rate while a stall is in progress (high on purpose:
    # the burst lasts only for the stall's duration).
    loop_stall_burst_hz: float = 200.0

    def __post_init__(self):
        if self.incident_dir:
            raise NotImplementedError(
                "telemetry.incident_dir (incident bundles)" + _NOT_PORTED)
        if self.journal_max_mb < 0:
            raise ValueError(
                f"telemetry.journal_max_mb must be >= 0 (0 = unbounded), "
                f"got {self.journal_max_mb}"
            )
        if self.memory_sample_every < 0:
            raise ValueError(
                f"telemetry.memory_sample_every must be >= 0 (0 = off), "
                f"got {self.memory_sample_every}"
            )
        if self.memory_topk < 1:
            raise ValueError(
                f"telemetry.memory_topk must be >= 1, got {self.memory_topk}"
            )
        for name in ("slo_ttft_target", "slo_tpot_target",
                     "slo_availability_target", "slo_gateway_e2e_target"):
            v = getattr(self, name)
            if not 0.0 < v < 1.0:
                # target == 1.0 has zero error budget: burn rate divides
                # by it — reject at config time, not at the first scrape.
                raise ValueError(
                    f"telemetry.{name} must be in (0, 1), got {v}"
                )
        for name in ("slo_ttft_s", "slo_tpot_s", "slo_gateway_e2e_s",
                     "slo_fast_window_s", "slo_slow_window_s",
                     "slo_burn_alert"):
            if getattr(self, name) <= 0:
                raise ValueError(
                    f"telemetry.{name} must be > 0, got {getattr(self, name)}"
                )
        if self.slo_fast_window_s >= self.slo_slow_window_s:
            raise ValueError(
                "telemetry.slo_fast_window_s must be shorter than "
                f"slo_slow_window_s, got {self.slo_fast_window_s} >= "
                f"{self.slo_slow_window_s}"
            )
        for name in ("flight_ring_size", "incident_max_bundles",
                     "anomaly_check_every_ticks", "anomaly_storm_threshold",
                     "anomaly_queue_depth", "anomaly_min_samples",
                     "anomaly_window"):
            if getattr(self, name) < 1:
                raise ValueError(
                    f"telemetry.{name} must be >= 1, got "
                    f"{getattr(self, name)}"
                )
        for name in ("incident_cooldown_s", "incident_max_mb",
                     "incident_trace_window_s", "anomaly_latency_factor",
                     "anomaly_loss_spike_factor",
                     "anomaly_grad_explosion_factor"):
            if getattr(self, name) <= 0:
                raise ValueError(
                    f"telemetry.{name} must be > 0, got {getattr(self, name)}"
                )
        if self.incident_journal_tail < 0:
            raise ValueError(
                f"telemetry.incident_journal_tail must be >= 0, got "
                f"{self.incident_journal_tail}"
            )
        if not 0.0 < self.anomaly_hit_ratio_floor < 1.0:
            raise ValueError(
                "telemetry.anomaly_hit_ratio_floor must be in (0, 1), got "
                f"{self.anomaly_hit_ratio_floor}"
            )
        for name in ("prof_hz", "loop_stall_threshold_s"):
            if getattr(self, name) < 0:
                raise ValueError(
                    f"telemetry.{name} must be >= 0 (0 = disarmed), got "
                    f"{getattr(self, name)}"
                )
        if self.prof_max_stacks < 1:
            raise ValueError(
                f"telemetry.prof_max_stacks must be >= 1, got "
                f"{self.prof_max_stacks}"
            )
        if self.loop_stall_burst_hz <= 0:
            raise ValueError(
                f"telemetry.loop_stall_burst_hz must be > 0, got "
                f"{self.loop_stall_burst_hz}"
            )

    def journal_max_bytes(self) -> int | None:
        """The journal rotation cap in bytes (None = unbounded) —
        the form ``EventJournal(max_bytes=...)`` takes."""
        return int(self.journal_max_mb * 1048576) or None

    def slo_windows(self) -> tuple[float, float]:
        return (self.slo_fast_window_s, self.slo_slow_window_s)

    def serving_slo_kwargs(self) -> dict:
        """Keyword form of the server objectives — exactly what
        ``telemetry.slo.serving_slo`` takes."""
        return dict(
            ttft_s=self.slo_ttft_s,
            ttft_target=self.slo_ttft_target,
            tpot_s=self.slo_tpot_s,
            tpot_target=self.slo_tpot_target,
            availability_target=self.slo_availability_target,
            windows=self.slo_windows(),
            burn_alert=self.slo_burn_alert,
        )

    def gateway_slo_kwargs(self) -> dict:
        """Keyword form of the gateway objectives — exactly what
        ``telemetry.slo.gateway_slo`` takes."""
        return dict(
            e2e_s=self.slo_gateway_e2e_s,
            e2e_target=self.slo_gateway_e2e_target,
            availability_target=self.slo_availability_target,
            windows=self.slo_windows(),
            burn_alert=self.slo_burn_alert,
        )

    def incident_kwargs(self) -> dict:
        """Keyword form of the bundle-hygiene knobs — exactly what
        ``telemetry.incident.IncidentManager`` takes."""
        return dict(
            cooldown_s=self.incident_cooldown_s,
            max_bundles=self.incident_max_bundles,
            max_total_mb=self.incident_max_mb,
            journal_tail=self.incident_journal_tail,
            trace_window_s=self.incident_trace_window_s,
        )

    def watchdog_kwargs(self) -> dict:
        """Keyword form of the loop-stall watchdog knobs — exactly what
        ``telemetry.prof.LoopWatchdog`` takes. Callers gate on
        ``loop_stall_threshold_s > 0`` before building one (0 =
        disarmed, and the watchdog itself rejects it)."""
        return dict(
            threshold_s=self.loop_stall_threshold_s,
            burst_hz=self.loop_stall_burst_hz,
        )

    def serving_detector_kwargs(self) -> dict:
        """Keyword form of the serving detector thresholds
        (``telemetry.anomaly.ServingDetector``)."""
        return dict(
            storm_threshold=self.anomaly_storm_threshold,
            queue_depth_limit=self.anomaly_queue_depth,
            latency_factor=self.anomaly_latency_factor,
            min_samples=self.anomaly_min_samples,
            hit_ratio_floor=self.anomaly_hit_ratio_floor,
        )

    def training_detector_kwargs(self) -> dict:
        """Keyword form of the training detector thresholds
        (``telemetry.anomaly.TrainingDetector``)."""
        return dict(
            window=self.anomaly_window,
            loss_spike_factor=self.anomaly_loss_spike_factor,
            grad_explosion_factor=self.anomaly_grad_explosion_factor,
        )


@dataclass(frozen=True)
class Config:
    """The sections the training launcher reads, and the server's
    ``telemetry`` section (``--telemetry-override``)."""

    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    api: APIConfig = field(default_factory=APIConfig)
    telemetry: TelemetryConfig = field(default_factory=TelemetryConfig)

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)


def _coerce(value: str, target_type: Any) -> Any:
    """Coerce a CLI string to the dataclass field's type (the JAX
    launcher's rules)."""
    if target_type in ("bool", bool):
        if value.lower() in ("1", "true", "yes", "on"):
            return True
        if value.lower() in ("0", "false", "no", "off"):
            return False
        raise ValueError(f"not a bool: {value!r}")
    for caster in (int, float):
        if target_type in (caster.__name__, caster):
            return caster(value)
    if value.lower() == "none":
        return None
    return value


# Sections of the JAX package's Config the port has no copy of yet.
_UNPORTED_SECTIONS = ("runtime", "mesh", "gateway", "autoscale", "kvtier",
                      "usage", "adapter", "chaos", "bulk")


def parse_overrides(config: Config, overrides: Sequence[str]) -> Config:
    """Apply ``section.key=value`` overrides, staged and applied once per
    section so validation sees only the final combination."""
    staged: dict[str, dict[str, Any]] = {}
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"override must be section.key=value, got {item!r}")
        path, value = item.split("=", 1)
        parts = path.split(".")
        if len(parts) != 2:
            raise ValueError(f"override path must be section.key, got {path!r}")
        section_name, key = parts
        if section_name in _UNPORTED_SECTIONS:
            raise NotImplementedError(f"config section {section_name!r}" + _NOT_PORTED)
        if not hasattr(config, section_name):
            raise ValueError(f"unknown config section {section_name!r}")
        section = getattr(config, section_name)
        matching = [f for f in fields(section) if f.name == key]
        if not matching:
            raise ValueError(f"unknown key {key!r} in section {section_name!r} "
                             "(or not ported to PyTorch yet, see ROADMAP.md)")
        staged.setdefault(section_name, {})[key] = _coerce(value, matching[0].type)
    for section_name, kv in staged.items():
        config = replace(
            config, **{section_name: replace(getattr(config, section_name), **kv)}
        )
    return config


def parse_model_overrides(cfg: ModelConfig, overrides: list[str]) -> ModelConfig:
    """Apply ``key=value`` overrides (the server's ``--override``), typed by
    the field they name; ``model.`` prefixes are accepted."""
    by_name = {f.name: f for f in fields(ModelConfig)}
    changes = {}
    for item in overrides:
        key, sep, raw = item.partition("=")
        key = key.strip()
        if key.startswith("model."):
            key = key[len("model."):]
        if not sep or key not in by_name:
            raise ValueError(
                f"bad override {item!r}: want FIELD=VALUE with FIELD one of "
                f"ModelConfig's fields"
            )
        changes[key] = _coerce(raw.strip(), by_name[key].type)
    return replace(cfg, **changes)
