"""Port parity of the continuous engine's telemetry: the metrics bundle, the
request spans and the flight recorder's tick ring against the JAX package's
``ContinuousEngine`` on the same weights and the same schedule.

Each schedule runs once per package (a module-level cache; the reference's
tiny f32 config, context 128, page size 16) with a journal-backed tracer:
plain ticks, more requests than slots, chunked prefill under a token budget
(the interference attribution), prompt-lookup speculation, optimistic
admission's preemption and exact resume, a deadline expiry, a cancel, a
queue-full refusal and a registered-prefix hit, on the contiguous cache and
on pages. These must equal the reference's: every counter's value and every
histogram's count (the by-class and prefix hit/miss TTFT families
included), the span trees (names, parent chains and the attributes that
are not times), the ``engine.tick`` instants, the ``TICK_RING`` rows but
their wall stamp, greedy tokens, and ``stats()``' keys apart from the
port's own (``PORT_STATS``). Times (queue waits, interference seconds, the
culprit a timing picks) are compared by key only. This file covers the
contiguous cache; ``tests/test_torch_paged_telemetry.py`` runs the same
checks on pages and adds the preemption schedule.
"""

import jax
import pytest

torch = pytest.importorskip("torch")

from ditl_tpu.config import ModelConfig as JaxModelConfig  # noqa: E402
from ditl_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer  # noqa: E402
from ditl_tpu.infer.continuous import ContinuousEngine as JaxEngine  # noqa: E402
from ditl_tpu.infer.continuous import QueueFullError as JaxQueueFullError  # noqa: E402
from ditl_tpu.infer.engine import GenerateConfig as JaxGenerateConfig  # noqa: E402
from ditl_tpu.models import llama as jllama  # noqa: E402
from ditl_tpu.telemetry.journal import EventJournal as JaxJournal  # noqa: E402
from ditl_tpu.telemetry.journal import read_journal  # noqa: E402
from ditl_tpu.telemetry.tracing import Tracer as JaxTracer  # noqa: E402
from ditl_tpu_torch.config import ModelConfig  # noqa: E402
from ditl_tpu_torch.data.tokenizer import ByteTokenizer  # noqa: E402
from ditl_tpu_torch.infer.continuous import ContinuousEngine, QueueFullError  # noqa: E402
from ditl_tpu_torch.infer.engine import GenerateConfig  # noqa: E402
from ditl_tpu_torch.models.convert import params_from_jax  # noqa: E402
from ditl_tpu_torch.telemetry import TICK_RING, EventJournal, Tracer  # noqa: E402
from ditl_tpu_torch.telemetry.tracing import NULL_TRACER  # noqa: E402

torch.set_num_threads(1)

TINY = dict(vocab_size=512, hidden_size=64, intermediate_size=128, num_layers=2,
            num_heads=4, num_kv_heads=2, head_dim=16, max_seq_len=128, dtype="float32")
MAX_NEW = 12
# stats() keys of the port that the reference's stats() does not have
PORT_STATS = {"ticks", "decode_ticks", "decode_steps", "decode_seconds", "prefills_cold",
              "prefills_prefix_hit"}
# Record keys of the span layer and the journal: ids, clocks, provenance.
RECORD_KEYS = {"ts", "seq", "source", "pid", "event", "name", "trace", "span", "parent",
               "dur_s"}
# Span and instant attributes that are times, or picked by a time (the
# tick's longest prefill names the culprit): compared by key only.
TIME_ATTRS = {"queue_wait_s", "interference_s", "interference_total_s", "prefill_s",
              "interference_culprit", "culprit_prefill_tokens"}

PROMPTS = ["hello world", "abc", "the quick brown fox", "x", "count 1 2 3 4"]
REPEAT = "one two one two one two one two one two"  # prompt lookup finds its drafts


def _ids(text: str) -> list[int]:
    return [1] + list(text.encode())


def _drain(eng) -> dict:
    done = {}
    steps = 0
    while eng.pending:
        eng.step()
        steps += 1
        assert steps < 2000
        done.update({r.req_id: r for r in eng.take_finished()})
    return done


def _submit_all(eng, texts, **kw) -> list[int]:
    return [eng.submit(_ids(t), **kw) for t in texts]


def _plain(eng, full):
    _submit_all(eng, PROMPTS[:2])
    return _drain(eng)


def _more_than_slots(eng, full):
    _submit_all(eng, PROMPTS)
    return _drain(eng)


def _chunked(eng, full):
    # a short request decodes while long prompts prefill in chunks beside it
    eng.submit(_ids("abc"), max_new_tokens=MAX_NEW)
    eng.step()
    eng.submit(_ids("r" * 70), max_new_tokens=MAX_NEW)
    eng.submit(_ids("q" * 100), max_new_tokens=MAX_NEW)
    return _drain(eng)


def _lookup(eng, full):
    _submit_all(eng, [REPEAT, REPEAT + " one", "abc"])
    return _drain(eng)


def _deadline(eng, full):
    _submit_all(eng, PROMPTS[:2])
    eng.submit(_ids("queued"), deadline_s=0.0)  # expires in the queue
    eng.step()
    slotted = next(r for r in eng._slots if r is not None)
    slotted.deadline = 0.0  # expires in its slot at the next step
    return _drain(eng)


def _cancel(eng, full):
    rids = _submit_all(eng, PROMPTS[:3])
    eng.step()
    eng.cancel(rids[2])  # queued
    eng.cancel(rids[0])  # in flight
    return _drain(eng)


def _queue_full(eng, full):
    eng.submit(_ids("abc"))
    with pytest.raises(full):
        eng.submit(_ids("refused"))
    return _drain(eng)


def _prefix(eng, full):
    prefix = _ids("you are a helpful assistant. " * 2)
    eng.register_prefix(prefix)
    eng.submit(prefix + list(b" say hi"))
    eng.submit(_ids("cold prompt"))
    eng.submit(list(prefix))  # the prompt is the prefix
    return _drain(eng)


# schedule -> (engine settings, driver)
CONTIGUOUS = {
    "plain": (dict(n_slots=2, decode_chunk=4), _plain),
    "more_than_slots": (dict(n_slots=2, decode_chunk=4), _more_than_slots),
    "chunked": (dict(n_slots=2, decode_chunk=4, prefill_chunk=36, token_budget=48), _chunked),
    "lookup": (dict(n_slots=2, decode_chunk=4, speculative=True, spec_k=4,
                    spec_threshold=0.0), _lookup),
    "deadline": (dict(n_slots=2, decode_chunk=4), _deadline),
    "cancel": (dict(n_slots=2, decode_chunk=4), _cancel),
    "queue_full": (dict(n_slots=1, decode_chunk=4, max_queue=1), _queue_full),
    "prefix": (dict(n_slots=2, decode_chunk=4), _prefix),
}


@pytest.fixture(scope="module")
def models():
    jcfg, cfg = JaxModelConfig(**TINY, param_dtype="float32"), ModelConfig(**TINY)
    params = jllama.init_params(jax.random.key(0), jcfg)
    return jcfg, params, cfg, params_from_jax(jax.device_get(params), cfg, "cpu")


def make_engine(models, port: bool, tracer=None, **kw):
    jcfg, jparams, cfg, tparams = models
    if port:
        return ContinuousEngine(tparams, cfg, ByteTokenizer(), device="cpu", tracer=tracer,
                                gen=GenerateConfig(max_new_tokens=MAX_NEW), **kw)
    return JaxEngine(jparams, jcfg, JaxByteTokenizer(), tracer=tracer,
                     gen=JaxGenerateConfig(max_new_tokens=MAX_NEW), **kw)


def registry_view(metrics) -> dict:
    """Every counter's and gauge's value and every histogram's count."""
    out = {}
    for name, m in metrics.registry._metrics.items():
        kind = type(m).__name__
        out[name] = (kind, m.count if kind == "Histogram" else m.value)
    return out


def span_view(records: list[dict]) -> list[tuple]:
    """The span records as sorted (name, ancestor names, non-time
    attributes, time attribute keys) tuples: the trees' shape, independent
    of ids, clocks and write order."""
    spans = [r for r in records if r["event"] == "trace.span"]
    by_id = {r["span"]: r for r in spans}
    out = []
    for r in spans:
        chain, p = [], r["parent"]
        while p in by_id:
            chain.append(by_id[p]["name"])
            p = by_id[p]["parent"]
        attrs = tuple(sorted((k, v) for k, v in r.items()
                             if k not in RECORD_KEYS and k not in TIME_ATTRS))
        out.append((r["name"], tuple(chain), attrs,
                    tuple(sorted(k for k in r if k in TIME_ATTRS))))
    return sorted(out, key=repr)


def instant_view(records: list[dict]) -> list[tuple]:
    return [tuple(sorted((k, v) for k, v in r.items()
                         if k not in RECORD_KEYS and k not in TIME_ATTRS))
            for r in records if r["event"] == "trace.instant"]


def flight_view(eng) -> list[dict]:
    return [{k: v for k, v in row.items() if k != "ts"}
            for row in eng.flight.ring(TICK_RING).dump()]


def run_schedule(models, tmp_dir, name: str, settings: dict, driver, port: bool) -> dict:
    path = str(tmp_dir / f"{name}-{'port' if port else 'jax'}.jsonl")
    journal = (EventJournal if port else JaxJournal)(path, source="engine")
    tracer = (Tracer if port else JaxTracer)(journal)
    eng = make_engine(models, port, tracer, **settings)
    done = driver(eng, QueueFullError if port else JaxQueueFullError)
    journal.close()
    records = read_journal(path)
    return {
        "tokens": {rid: list(r.tokens) for rid, r in done.items()},
        "metrics": registry_view(eng.metrics),
        "spans": span_view(records),
        "instants": instant_view(records),
        "flight": flight_view(eng),
        "stats_keys": set(eng.stats()),
        "spans_open": sum(r.request_span is not None or r.queue_span is not None
                          for r in done.values()),
    }


class Results:
    """Each (schedule, package) run once, on first use, over a module."""

    def __init__(self, models, tmp_dir, schedules: dict):
        self.models, self.tmp_dir, self.schedules = models, tmp_dir, schedules
        self._runs: dict = {}

    def get(self, name: str, port: bool) -> dict:
        key = (name, port)
        if key not in self._runs:
            settings, driver = self.schedules[name]
            self._runs[key] = run_schedule(self.models, self.tmp_dir, name, settings,
                                           driver, port)
        return self._runs[key]


@pytest.fixture(scope="module")
def results(models, tmp_path_factory):
    return Results(models, tmp_path_factory.mktemp("contiguous"), CONTIGUOUS)


def check_schedule(results, name: str) -> None:
    ref, ours = results.get(name, False), results.get(name, True)
    assert ours["tokens"] == ref["tokens"]
    assert ours["metrics"] == ref["metrics"]
    assert ours["spans"] == ref["spans"]
    assert ours["instants"] == ref["instants"]
    assert ours["flight"] == ref["flight"]
    assert ours["stats_keys"] - PORT_STATS == ref["stats_keys"]
    assert ours["spans_open"] == 0
    # each engine.request span carries its request's tokens
    n_req = sum(1 for s in ours["spans"] if s[0] == "engine.request")
    assert n_req == ours["metrics"]["ditl_serving_requests"][1]


@pytest.mark.parametrize("name", sorted(CONTIGUOUS))
def test_contiguous_telemetry_equals_the_reference(results, name):
    check_schedule(results, name)


def test_schedules_reach_what_they_are_for(results):
    """The schedules exercise their features: interference under the
    budget, accepted drafts, an expiry in the queue and in a slot, a
    refusal, a prefix hit and a prompt-is-the-prefix admission."""
    m = {n: results.get(n, True)["metrics"] for n in CONTIGUOUS}
    assert m["chunked"]["ditl_serving_tpot_interference_seconds"][1] > 0
    assert m["lookup"]["ditl_serving_spec_accepted_tokens"][1] > 0
    assert m["deadline"]["ditl_serving_deadline_expired"][1] == 2
    assert m["queue_full"]["ditl_serving_queue_full"][1] == 1
    assert m["prefix"]["ditl_serving_request_ttft_cache_hit_seconds"][1] == 2
    assert m["prefix"]["ditl_serving_request_ttft_cache_miss_seconds"][1] == 1
    spans = results.get("cancel", True)["spans"]
    assert sum(("cancelled", True) in s[2] for s in spans if s[0] == "engine.request") == 2


def test_unarmed_tracer_writes_nothing_and_tokens_hold(models, results, tmp_path):
    """No tracer (the default) and ``Tracer(None)`` open no span; the
    tokens and the metrics' counts are those of the armed run."""
    settings, driver = CONTIGUOUS["chunked"]
    armed = results.get("chunked", True)
    for tracer in (None, Tracer(None)):
        eng = make_engine(models, True, tracer, **settings)
        assert eng.tracer is NULL_TRACER if tracer is None else eng.tracer is tracer
        done = driver(eng, QueueFullError)
        assert {rid: r.tokens for rid, r in done.items()} == armed["tokens"]
        assert all(r.request_span is None and r.queue_span is None for r in done.values())
        counts = {k: v for k, v in registry_view(eng.metrics).items()}
        assert counts == armed["metrics"]
    assert list(tmp_path.iterdir()) == []
