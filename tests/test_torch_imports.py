"""The port stands alone: ``ditl_tpu_torch`` and ``chip_smoke.py`` import
neither JAX nor anything of the JAX package, and the copies the port keeps of
jax-free modules (``ModelConfig``, ``DataConfig``, ``TrainConfig``,
``APIConfig``, ``TelemetryConfig``'s overrides, the presets, the byte
tokenizer, the keep-alive mixin, the dataset and sampler) match their
originals; ``tests/test_torch_client.py`` holds the client, the fault plane
and the metrics registry to theirs, ``tests/test_torch_telemetry.py`` the
other telemetry modules."""

import ast
import dataclasses
import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import ditl_tpu_torch  # noqa: E402
from ditl_tpu import config as jconfig  # noqa: E402
from ditl_tpu.data import tokenizer as jtokenizer  # noqa: E402
from ditl_tpu.models import presets as jpresets  # noqa: E402
from ditl_tpu.utils import http11 as jhttp11  # noqa: E402
from ditl_tpu_torch import config as tconfig  # noqa: E402
from ditl_tpu_torch.data import tokenizer as ttokenizer  # noqa: E402
from ditl_tpu_torch.models import presets as tpresets  # noqa: E402
from ditl_tpu_torch.utils import http11 as thttp11  # noqa: E402
from ditl_tpu_torch.utils import logging as tlogging  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "ditl_tpu_torch"
SMOKE = ROOT / "chip_smoke.py"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "ditl_tpu"}


def _port_modules() -> list[str]:
    return sorted(m.name for m in pkgutil.walk_packages([str(PORT)], "ditl_tpu_torch."))


def _imported_names(path: Path) -> set[str]:
    """Every module an ``import`` statement in ``path`` names, at any depth
    (imports inside functions included)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
    return names


def _sources() -> list[Path]:
    return sorted(PORT.rglob("*.py")) + [SMOKE]


def test_port_package_has_modules():
    mods = _port_modules()
    for name in ("config", "models.llama", "models.convert", "models.presets",
                 "ops.attention", "ops.flash_attention", "ops.paged_attention",
                 "ops.cuda_build", "infer.cache", "infer.paged_cache",
                 "infer.sampling", "infer.engine", "infer.continuous",
                 "infer.server", "data.tokenizer", "utils.logging", "utils.http11",
                 "data.dataset", "data.sampler", "data.loader", "ops.fused_ce",
                 "train.state", "train.step", "train.metrics", "train.trainer",
                 "train.checkpoint",
                 "launch", "ops.mlp", "ops.mlp_bwd", "ops.projection",
                 "tools.profile_train", "ops.quant", "infer.speculative",
                 "client", "client.llm", "client.eval_loop", "chaos", "chaos.plane",
                 "telemetry", "telemetry.registry", "runtime", "runtime.distributed",
                 "ops.encode", "native", "native.build", "native.fsm", "infer.grammar",
                 "annotations", "telemetry.journal", "telemetry.tracing",
                 "telemetry.flight", "telemetry.serving", "telemetry.slo",
                 "telemetry.trace_export"):
        assert f"ditl_tpu_torch.{name}" in mods
    for source in ("flash_fwd.cu", "paged_attention.cu", "flash_bwd.cu", "mlp_bwd.cu",
                   "projection_bwd.cu", "fsm.cpp"):
        assert (PORT / "csrc" / source).is_file()


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax(path):
    bad = {n for n in _imported_names(path) if n.split(".")[0] in FORBIDDEN}
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_importing_port_and_smoke_closure_loads_no_jax():
    """A fresh interpreter imports every port module, chip_smoke.py and
    everything chip_smoke.py imports anywhere; neither jax nor a
    ``ditl_tpu`` module may then be loaded."""
    closure = sorted(n for n in _imported_names(SMOKE) if n != "__future__")
    code = f"""
import importlib, json, sys
sys.path.insert(0, {str(ROOT)!r})
for name in {_port_modules() + closure + ['chip_smoke']!r}:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in {sorted(FORBIDDEN)!r})
print(json.dumps(bad))
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def _fields(cls) -> dict:
    return {f.name: (f.default, str(f.type)) for f in dataclasses.fields(cls)}


def test_model_config_matches_jax_field_for_field():
    """Every field of the port's copy is the JAX field of that name, with its
    type and default, in the same order; the copy leaves out only what the
    port's forward and serving never read."""
    jf, tf = _fields(jconfig.ModelConfig), _fields(tconfig.ModelConfig)
    assert {name: jf.get(name) for name in tf} == tf
    assert list(tf) == [name for name in jf if name in tf]
    assert set(jf) - set(tf) == {
        "num_experts_per_tok", "router_aux_coef", "lora_alpha", "lora_dropout",
        "flash_block_q", "flash_block_kv", "flash_block_q_bwd", "flash_block_kv_bwd",
        "scan_unroll", "pipeline_microbatches"}


@pytest.mark.parametrize("name,left_out", [
    ("DataConfig", set()),
    ("TrainConfig", {"max_restarts", "fault_kill_process",
                     "heartbeat_dir", "heartbeat_timeout_s", "straggler_lag_steps",
                     "straggler_relaunch", "profile_start_step", "profile_num_steps"}),
])
def test_data_and_train_config_match_jax_field_for_field(name, left_out):
    """The port's copies keep the JAX fields of their names, types and
    defaults, in the same order, leaving out only the listed knobs of
    features the port does not run (restarts, heartbeats, profiling
    windows)."""
    jf, tf = _fields(getattr(jconfig, name)), _fields(getattr(tconfig, name))
    assert {n: jf.get(n) for n in tf} == tf
    assert list(tf) == [n for n in jf if n in tf]
    assert set(jf) - set(tf) == left_out


def test_config_sections_and_override_coercion_match_jax():
    """``parse_overrides`` types values as the JAX launcher does, over the
    sections both packages have."""
    items = ["model.num_layers=3", "model.rope_theta=10000", "model.tie_embeddings=yes",
             "data.seq_len=64", "data.synthetic=on", "train.learning_rate=1e-2",
             "train.optimizer=adafactor", "train.metrics_file=none",
             "train.eval_every=3", "train.eval_samples=4", "api.api_base=http://h:1/v1",
             "api.total_timeout_s=2.5", "api.max_retries=1", "api.api_key_env=none",
             "telemetry.slo_ttft_s=0.5", "telemetry.journal_max_mb=8",
             "telemetry.flight_ring_size=64"]
    ours = tconfig.parse_overrides(tconfig.Config(), items)
    ref = jconfig.parse_overrides(jconfig.Config(), items)
    assert [f.name for f in dataclasses.fields(tconfig.Config)] == [
        "model", "data", "train", "api", "telemetry"]
    for section in ("model", "data", "train", "api", "telemetry"):
        mine = dataclasses.asdict(getattr(ours, section))
        theirs = dataclasses.asdict(getattr(ref, section))
        assert mine == {k: theirs[k] for k in mine}, section


def test_model_config_rejects_unported_attention():
    for impl in ("xla", "flash"):
        assert tconfig.ModelConfig(attention_impl=impl).attention_impl == impl
    for impl in ("ring", "ulysses", "splash"):
        with pytest.raises(ValueError, match="ROADMAP"):
            tconfig.ModelConfig(attention_impl=impl)


def test_overrides_are_typed_by_field():
    cfg = tconfig.parse_model_overrides(
        tconfig.ModelConfig(), ["attention_impl=flash", "model.num_layers=3",
                                "rope_theta=10000", "fused_qkv=true"])
    assert (cfg.attention_impl, cfg.num_layers, cfg.rope_theta, cfg.fused_qkv) == (
        "flash", 3, 10000.0, True)
    with pytest.raises(ValueError, match="bad override"):
        tconfig.parse_model_overrides(tconfig.ModelConfig(), ["num_layers"])


@pytest.mark.parametrize("name", sorted(jpresets.PRESETS))
def test_presets_match_jax(name):
    """Same values on the port's fields; every field the port leaves out is
    at its JAX default in the JAX preset, so no preset loses a setting."""
    ours = dataclasses.asdict(tpresets.get_preset(name))
    ref = dataclasses.asdict(jpresets.get_preset(name))
    assert ours == {k: ref[k] for k in ours}
    defaults = dataclasses.asdict(jconfig.ModelConfig())
    assert {k: v for k, v in ref.items() if k not in ours} == {
        k: defaults[k] for k in ref if k not in ours}


def test_dataset_and_sampler_match_jax():
    from ditl_tpu.data import dataset as jdataset
    from ditl_tpu.data import sampler as jsampler
    from ditl_tpu_torch.data import dataset as tdataset
    from ditl_tpu_torch.data import sampler as tsampler

    a, b = tdataset.synthetic_dataset(37, 5), jdataset.synthetic_dataset(37, 5)
    assert (a.texts, a.labels) == (b.texts, b.labels) and a[3] == b[3]
    for kw in (dict(shuffle=True, seed=3), dict(shuffle=False, drop_last=True)):
        for n, replicas, rank in ((37, 1, 0), (37, 4, 3), (5, 8, 6)):
            ours = tsampler.ShardedSampler(n, replicas, rank, **kw)
            ref = jsampler.ShardedSampler(n, replicas, rank, **kw)
            for epoch in (0, 2):
                ours.set_epoch(epoch)
                ref.set_epoch(epoch)
                assert list(ours) == list(ref) and len(ours) == len(ref)


def test_byte_tokenizer_and_vocab_check_match_jax():
    jt, tt = jtokenizer.ByteTokenizer(), ttokenizer.ByteTokenizer()
    text = "héllo, wörld ✓"
    assert tt.encode(text) == jt.encode(text)
    ids = tt.encode(text) + [0, 1, 2, 259, 5000]
    assert tt.decode(ids) == jt.decode(ids)
    assert (tt.pad_id, tt.bos_id, tt.eos_id, tt.vocab_size) == (
        jt.pad_id, jt.bos_id, jt.eos_id, jt.vocab_size)
    with pytest.raises(ValueError, match="exceeds"):
        ttokenizer.check_vocab(tt, 100, "test")
    ttokenizer.check_vocab(tt, 512, "test")
    assert isinstance(ttokenizer.get_tokenizer("byte"), ttokenizer.ByteTokenizer)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ttokenizer.get_tokenizer("meta-llama/Meta-Llama-3-8B")


def test_http11_mixin_matches_jax():
    for attr in ("protocol_version", "disable_nagle_algorithm", "timeout"):
        assert getattr(thttp11.KeepAliveHandlerMixin, attr) == getattr(
            jhttp11.KeepAliveHandlerMixin, attr)


def test_logging_rank_without_process_group():
    assert tlogging._process_index() == 0
    tlogging.setup_logging("DEBUG")
    tlogging.setup_logging("INFO")  # re-entrant: one handler of its own
    import logging

    ours = [h for h in logging.getLogger().handlers if h is tlogging._handler]
    assert len(ours) == 1
    assert ditl_tpu_torch.__version__
