"""OpenAI-compatible HTTP server over the port's engines.

Counterpart of the JAX package's ``infer/server.py``: ``GET /health``,
``GET /v1/models``, ``GET /v1/stats``, ``GET /metrics``, ``GET /slo``
(``/v1/slo``), ``POST /v1/completions`` and
``POST /v1/chat/completions`` with ``stop``, ``max_tokens``,
``temperature``, ``top_p``, ``seed``, ``logprobs``/``top_logprobs``,
``stream``, ``n``/``best_of``, ``deadline_s``, ``slo_class`` and guided
decoding (``guided_regex``, ``guided_json``, ``response_format``), and
``POST /v1/embeddings``.

- ``"stream": true`` answers Server-Sent Events (``data: {...}`` chunks,
  then ``data: [DONE]``, ``Connection: close``): the continuous engine
  streams each harvest's tokens as they decode (``ThreadedEngine.stream_one``,
  submitted before the headers go out, so a full queue still answers 429);
  the lock-step engine generates the whole answer (speculatively when
  eligible) and sends it as one chunk. Chat streams open with the role
  chunk; text that could begin a stop sequence is held back across chunk
  boundaries; a client that goes away cancels its request, freeing its
  slot. Streamed logprobs ride the continuous engine with ``--logprobs-k``
  >= N and no stop sequence (each chunk carries its tokens' logprobs, in
  the reference's layout); otherwise they answer 400.
- ``n``/``best_of`` (``1 <= n <= best_of <= 8``; 400 with ``stream`` or
  ``logprobs``): ``best_of`` candidates, the best ``n`` by mean token
  logprob when ``best_of > n``; the continuous engine runs them side by side
  (copy i seeded ``derive_copy_seed(seed, i)``; ranking needs
  ``--logprobs-k``), the lock-step Generator as one batch; usage counts
  every candidate.
- ``deadline_s`` or the ``X-Request-Deadline-S`` header: at or below 0 a 504
  before any work; the continuous engine's single-choice path evicts a
  request past it (504). Elsewhere a payload deadline answers 400 and the
  header's is dropped.
- ``slo_class`` or the ``X-SLO-Class`` header (the header wins; an unknown
  class answers 400) orders the continuous engine's admission and
  preemption; where no class orders the work (the lock-step engine, a
  logprob request beyond ``--logprobs-k``) a payload class other than
  ``interactive`` answers 400 and the header's is dropped.
- Guided decoding (``--engine continuous --fsm-capacity N``): at most one of
  ``guided_regex`` (a fullmatch regex), ``guided_json`` (a JSON schema,
  object or string) and ``response_format`` (``json_object``, or
  ``json_schema`` with its ``schema``) constrains the completion; each spec
  compiles once (``infer/grammar.py``, a 64-entry LRU keyed by the spec) and
  the engine registers its table once. It rides the plain, streamed,
  ``n``/``best_of``, logprob (N <= ``--logprobs-k``), deadline and
  ``slo_class`` paths of the continuous engine. A bad spec, a server not
  armed, logprobs beyond ``--logprobs-k`` and ``best_of`` ranking without
  ``--logprobs-k`` answer 400 with the reference's messages; a grammar that
  no longer fits the table 503 (new grammars need a restart with a larger
  ``--fsm-capacity``). The port serves no LoRA adapters, so the reference's
  refusal of guided decoding under adapter routing has no request to
  answer: the ``model`` field stays advisory, as on the reference's
  adapter-less servers.
- ``/v1/embeddings``: mean-pooled, unit-length final hidden states of the
  served model (one forward over the padded batch, under the device lock).
- Telemetry (``telemetry/``): ``/metrics`` is Prometheus text, the serving
  bundle's histograms and counters (the continuous engine's own, else the
  lock-step paths' requests, completions, tokens and end-to-end latency),
  the SLO gauges, the ``/v1/stats`` snapshot as ``ditl_serving_*`` gauges
  and ``ditl_serving_up``; ``/slo`` grades the TTFT, TPOT and availability
  objectives over burn-rate windows (``--telemetry-override
  slo_ttft_s=0.5`` and the other ``TelemetryConfig`` fields tune them);
  ``/health`` adds ``ttft_p95_s`` and ``tpot_p95_s`` once something has
  been served. Every response echoes the client's ``X-Request-Id`` or a
  generated ``req-`` one; a completion opens a ``server.request`` span
  under the client's W3C ``traceparent``, and the continuous engine's
  spans chain under it. ``--trace-dir DIR`` arms the tracer: the spans go
  to ``DIR/events-server-<pid>.jsonl`` (``python -m
  ditl_tpu_torch.telemetry.trace_export --dir DIR`` makes a Chrome trace).
  A 429's ``Retry-After`` is the seconds the backlog takes to clear at the
  measured completion rate, in [1, 30].

- ``--engine lockstep`` (default): the lock-step ``Generator``; a lock
  serialises device work.
- ``--engine continuous``: the continuous engine (``infer/continuous.py``)
  behind ``ThreadedEngine``, so concurrent requests share decode ticks,
  over the contiguous KV cache (``--cache-mode contiguous``, the default:
  one max-context row per slot) or the paged one (``--cache-mode paged``:
  a shared page pool with automatic prefix reuse). ``--admission
  optimistic`` (paged only) books a request's pages a tick at a time and
  preempts on an empty pool (exact resume); ``--logprobs-k K`` serves
  logprob requests of N <= K on the engine, the others fall back to the
  lock-step ``Generator`` over the same weights, as the JAX server does. A
  full admission queue (``--max-queue``) answers 429, an invalid request
  400; ``/v1/stats`` reports the engine's stats, and ``/health`` its queue,
  slots and prefix-cache tokens, with the page pool's fields on pages.

``--max-pending`` answers 429 beyond that many requests in flight.
Adapters, usage metering, incident bundles and pod serving are later
slices (ROADMAP.md). ``--checkpoint-dir`` serves the newest verified step of a
training run's checkpoints (``train/checkpoint.py``: its masters turned into
the serving tree, checked against the preset and overrides, which must be
the trained model's); without it, or when the directory holds no step that
restores, the weights are drawn from ``--seed``. ``--kv-quant int8`` makes
the KV caches int8 (set before the weights are made; the paged decode runs
K3 over int8 pools), ``--quantize int8`` turns the weights into weight-only
int8 (``ops/quant.py``; with ``--checkpoint-dir`` the restored masters are
quantized in their own dtype before the serving cast, as the JAX server
quantizes its f32 masters); both engines serve the result. ``--override
dtype=bfloat16|float16|float32`` picks the compute dtype, which the weights,
the tails and the float caches take; each dtype, with or without
``--kv-quant int8``, has its own flash and paged kernels on the card
(``ops/flash_attention.py`` and ``ops/paged_attention.py``,
``kernel_route``).
``--speculative on|auto`` (default ``off``) serves with prompt-lookup
speculative decoding (``infer/speculative.py``): the continuous engine runs
speculative ticks (``on`` every tick, ``auto`` when the measured acceptance
clears the measured cost ratio), the lock-step engine serves greedy requests
through ``SpeculativeGenerator`` (``on``) or ``AutoSpeculativeGenerator``
(``auto``), falling back to the plain ``Generator`` when the speculative
program's k + 1 slack does not fit the context. ``--draft-preset NAME``
(continuous engine, ``--speculative on|auto``) drafts with that preset's
model, in its own dtype, instead of prompt lookup: seed-initialised, or
restored from ``--draft-checkpoint DIR`` (a training run's checkpoints);
its vocabulary must be the target's. ``--prefill-chunk N`` (under
``--cache-mode paged`` a multiple of ``--page-size``) prefills longer
prompts one chunk a tick, and
``--token-budget T`` caps each tick's prefill at what its decode steps
leave of T; ``/v1/stats`` reports ``slots_prefilling``,
``max_tick_prefill_tokens`` and the speculative block's ``drafter``. On the
card unless ``--device cpu`` is given:

    python -m ditl_tpu_torch.infer.server --preset llama3-8b \\
        --override attention_impl=flash [--checkpoint-dir DIR] [--device cuda] \\
        [--port 8300] [--engine continuous [--cache-mode paged]] \\
        [--override dtype=float16|float32] [--quantize int8] [--kv-quant int8] \\
        [--speculative on|auto [--draft-preset NAME [--draft-checkpoint DIR]]] \
        [--prefill-chunk 512 --token-budget 640] [--admission optimistic] \\
        [--logprobs-k 5] [--fsm-capacity 1200] [--trace-dir DIR] \\
        [--telemetry-override slo_ttft_s=0.5]
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import random
import socket
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ditl_tpu_torch.infer.continuous import (
    SLO_CLASSES,
    DeadlineExceededError,
    QueueFullError,
    ThreadedEngine,
)
from ditl_tpu_torch.infer.engine import GenerateConfig, Generator, _next_pow2
from ditl_tpu_torch.telemetry.serving import (
    ServingMetrics,
    backlog_retry_after,
    flattened_stats_lines,
)
from ditl_tpu_torch.telemetry.slo import BurnRateMonitor, serving_slo
from ditl_tpu_torch.telemetry.tracing import (
    NULL_TRACER,
    Tracer,
    parse_traceparent,
    resolve_request_id,
)
from ditl_tpu_torch.utils.http11 import KeepAliveHandlerMixin
from ditl_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

__all__ = ["DrainableHTTPServer", "make_server", "create_server", "serve", "telemetry_from_args"]


class DrainableHTTPServer(ThreadingHTTPServer):
    """``ThreadingHTTPServer`` with in-flight accounting and a graceful drain:
    ``drain()`` flips /health to draining and makes new completions answer
    503; ``close(drain=True)`` waits for in-flight work, then stops."""

    daemon_threads = True

    def __init__(self, *args, **kwargs):
        self.draining = False
        self.engine: ThreadedEngine | None = None  # stopped by close()
        self._inflight = 0
        self._idle = threading.Condition()
        self._parked: set = set()
        self._conn_lock = threading.Lock()
        # (wall time, completed count) samples: the service rate behind the
        # backlog-aware Retry-After (_Handler._retry_after_s).
        self._rate_samples: collections.deque = collections.deque(maxlen=64)
        super().__init__(*args, **kwargs)

    def shutdown_request(self, request):
        with self._conn_lock:
            self._parked.discard(request)
        super().shutdown_request(request)

    def note_parked(self, request, parked: bool) -> None:
        with self._conn_lock:
            if parked:
                self._parked.add(request)
            else:
                self._parked.discard(request)

    def handle_error(self, request, client_address):
        import sys

        if isinstance(sys.exc_info()[1], OSError):  # client went away
            logger.debug("connection error from %s", client_address)
            return
        super().handle_error(request, client_address)

    def _enter_request(self) -> int:
        with self._idle:
            self._inflight += 1
            return self._inflight

    def _exit_request(self) -> None:
        with self._idle:
            self._inflight -= 1
            self._idle.notify_all()

    @property
    def inflight(self) -> int:
        return self._inflight

    def drain(self) -> None:
        """New completions get 503; idle kept-alive connections are severed."""
        self.draining = True
        with self._conn_lock:
            parked = list(self._parked)
        for s in parked:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass

    def close(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Drain, wait (bounded) for in-flight work, stop the serve loop,
        close the socket and stop the continuous engine's driver thread.
        Call from a thread other than ``serve_forever``'s."""
        if drain:
            self.drain()
            with self._idle:
                if not self._idle.wait_for(lambda: self._inflight == 0, timeout):
                    logger.warning("drain timed out with %d request(s) in flight",
                                   self._inflight)
        self.shutdown()
        self.server_close()
        if self.engine is not None:
            self.engine.close()


def _stop_list(stop) -> list[str]:
    """OpenAI's ``stop`` (str | list | None) as at most 4 sequences."""
    if not stop:
        return []
    if isinstance(stop, str):
        stop = [stop]
    if not isinstance(stop, list) or any(not isinstance(s, str) for s in stop):
        raise ValueError("stop must be a string or an array of strings")
    return [s for s in stop if s][:4]


def _apply_stop(text: str, stops: list[str]) -> tuple[str, bool]:
    """Cut at the earliest stop sequence (excluded, per OpenAI)."""
    cut = None
    for s in stops:
        i = text.find(s)
        if i >= 0 and (cut is None or i < cut):
            cut = i
    return (text, False) if cut is None else (text[:cut], True)


class _StopTracker:
    """Streaming stop handling (the reference's): emits increments, holding
    back any trailing text that could be the start of a stop sequence
    spanning a chunk boundary."""

    def __init__(self, stops: list[str]):
        self.stops = stops
        self.acc = ""
        self.sent = 0
        self.hit = False

    def push(self, piece: str) -> str:
        """Add decoded text; return what is safe to emit now."""
        if self.hit:
            return ""
        self.acc += piece
        cut, self.hit = _apply_stop(self.acc, self.stops)
        if self.hit:
            out = cut[self.sent:]
            self.sent = len(cut)
            return out
        hold = 0
        for s in self.stops:
            for k in range(1, len(s)):
                if self.acc.endswith(s[:k]):
                    hold = max(hold, k)
        safe = len(self.acc) - hold
        out = self.acc[self.sent: safe] if safe > self.sent else ""
        self.sent = max(self.sent, safe)
        return out

    def flush(self) -> str:
        """End of stream: release any held-back stop-prefix text."""
        if self.hit:
            return ""
        out = self.acc[self.sent:]
        self.sent = len(self.acc)
        return out


class _Detokenizer:
    """Token chunks -> text increments whose concatenation is the decode of
    all the tokens. Each push decodes the whole sequence so far and emits
    what is new, holding back a trailing U+FFFD: it may be the start of a
    UTF-8 character whose bytes arrive in the next chunk (decoding each
    chunk alone, as the reference does, would turn such a split character
    into replacement characters)."""

    def __init__(self, tokenizer):
        self.tokenizer = tokenizer
        self.ids: list[int] = []
        self.sent = 0

    def push(self, chunk: list[int]) -> str:
        self.ids.extend(chunk)
        text = self.tokenizer.decode(self.ids)
        safe = len(text.rstrip("\ufffd"))
        out = text[self.sent: safe] if safe > self.sent else ""
        self.sent = max(self.sent, safe)
        return out

    def flush(self) -> str:
        text = self.tokenizer.decode(self.ids)
        out = text[self.sent:]
        self.sent = len(text)
        return out


def _chat_prompt(messages: list[dict]) -> str:
    """Chat messages -> prompt as plain-text role turns (the byte tokenizer's
    rendering; chat templates come with Hugging Face tokenizers)."""
    parts = [f"{m.get('role', 'user')}: {m.get('content', '')}" for m in messages]
    return "\n".join(parts) + "\nassistant:"


class _Handler(KeepAliveHandlerMixin, BaseHTTPRequestHandler):
    generator: Generator = None  # bound by make_server
    threaded_engine: ThreadedEngine | None = None  # --engine continuous
    spec_generator = None  # lock-step --speculative on|auto
    model_name: str = "ditl-tpu-torch"
    device_lock: threading.Lock = None  # serialises the lock-step Generator
    default_max_tokens: int = 64
    max_pending: int | None = None
    stats: dict = None  # served requests and tokens, guarded by stats_lock
    stats_lock: threading.Lock = None
    grammar_cache: collections.OrderedDict = None  # spec key -> CompiledGrammar (LRU)
    grammar_lock: threading.Lock = None
    # Telemetry (bound by make_server): the serving bundle /metrics renders
    # (the continuous engine's own, else one the lock-step paths record
    # into), the span tracer (the engine's, so one knob arms the replica)
    # and the SLO burn-rate monitor /slo grades.
    serving_metrics: ServingMetrics = None
    tracer: Tracer = NULL_TRACER
    slo: BurnRateMonitor = None

    def log_message(self, *args):
        logger.debug("http: " + args[0], *args[1:])

    def _request_id(self) -> str:
        """The request's id: the client's sanitized ``X-Request-Id``, else a
        generated ``req-`` one, echoed on every response (JSON, 4xx, 429,
        503, 504, SSE). Reset per request: one handler serves every request
        of a kept-alive connection."""
        rid = getattr(self, "_rid", None)
        if rid is None:
            rid = self._rid = resolve_request_id(self.headers.get("X-Request-Id"))
        return rid

    def _send_json(self, status: int, payload: dict, headers: dict | None = None) -> None:
        body = json.dumps(payload).encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("X-Request-Id", self._request_id())
        for key, value in (headers or {}).items():
            self.send_header(key, value)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _sample_service_rate(self) -> None:
        """One (now, completed) sample for the Retry-After derivation, after
        every completion-shaped request."""
        self.server._rate_samples.append((time.time(), self.serving_metrics.completed.value))

    def _retry_after_s(self) -> int:
        """Seconds until the current backlog (queued plus active requests)
        clears at the recently measured service rate, clamped to [1, 30]
        (``telemetry/serving.backlog_retry_after``)."""
        self._sample_service_rate()
        load = self._load()
        return backlog_retry_after(self.server._rate_samples,
                                   load["queue_depth"] + load["active_slots"])

    def _send_429(self, message: str) -> None:
        """OpenAI's rate-limit answer, its ``Retry-After`` from the backlog so
        a herd of clients does not retry at one instant."""
        self._send_json(429, {"error": {"message": message, "type": "rate_limit_error"}},
                        headers={"Retry-After": str(self._retry_after_s())})

    def _load(self) -> dict:
        """The load signal of ``/health``, as the reference's
        ``_load_snapshot``: queue and slots, the prefix cache's hit and miss
        tokens, the measured rates where the engine has them, and the page
        pool's fields where it has pages."""
        if self.threaded_engine is not None:
            st = self.threaded_engine.stats()
            out = {"queue_depth": st["queue_depth"], "active_slots": st["slots_busy"],
                   "n_slots": st["n_slots"],
                   "cache_hit_tokens": st["prefix_cache"]["hit_tokens"],
                   "cache_miss_tokens": st["prefix_cache"]["miss_tokens"]}
            for key in ("prefill_tok_per_s", "kv_bytes_per_token", "pages_free",
                        "pages_cached_evictable", "pages_total"):
                if key in st:
                    out[key] = st[key]
            return out
        inflight = int(self.server.inflight)
        return {"queue_depth": max(0, inflight - 1),
                "active_slots": min(1, inflight), "n_slots": 1}

    def do_GET(self):
        self._rid = None  # a fresh id per request on a kept-alive connection
        path = self.path.rstrip("/")
        draining = bool(self.server.draining)
        if path in ("/health", "/v1/health"):
            payload = {"status": "draining" if draining else "ok",
                       "model": self.model_name, "draining": draining, **self._load()}
            # lifetime p95s, once something has been served
            m = self.serving_metrics
            for key, hist in (("ttft_p95_s", m.ttft), ("tpot_p95_s", m.decode_token)):
                q = hist.quantile(0.95) if hist.count else None
                if q is not None:
                    payload[key] = round(q, 6)
            self._send_json(200, payload)
        elif path in ("/v1/stats", "/stats"):
            with self.stats_lock:
                served = dict(self.stats)
            engine = ({"engine": "lockstep"} if self.threaded_engine is None
                      else self.threaded_engine.stats())
            if self.spec_generator is not None:
                engine["speculative"] = True
                acc = self._spec_acceptance()
                if acc is not None:
                    engine["speculative_acceptance"] = round(acc, 3)
            self._send_json(200, {"model": self.model_name, **engine,
                                  "device": str(self.generator.device),
                                  "draining": draining,
                                  "inflight": int(self.server.inflight),
                                  **self._load(), **served})
        elif path in ("/v1/models", "/models"):
            self._send_json(200, {"object": "list", "data": [
                {"id": self.model_name, "object": "model"}]})
        elif path == "/metrics":
            self._metrics()
        elif path in ("/slo", "/v1/slo"):
            self._send_json(200, self.slo.report())  # the scrape is its sample tick
        else:
            self._send_json(404, {"error": {"message": f"no route {self.path}"}})

    def _metrics(self) -> None:
        """Prometheus text exposition, no device sync: the serving
        registry's real series (histograms as ``_bucket``/``_sum``/``_count``,
        ``_total`` counters, the SLO gauges refreshed by this scrape), then
        the ``/v1/stats`` snapshot flattened to ``ditl_serving_<path>``
        gauges that shadow no registry family, then ``ditl_serving_up``.
        The reference's HBM gauges (``telemetry/memwatch.py``) are not
        ported yet (ROADMAP.md)."""
        stats: dict = {}
        if self.threaded_engine is not None:
            stats.update(self.threaded_engine.stats())
        if self.spec_generator is not None:
            # lock-step speculative serving: the acceptance /v1/stats reports
            stats["lockstep_speculative"] = True
            acc = self._spec_acceptance()
            if acc is not None:
                stats["lockstep_speculative_acceptance"] = round(acc, 3)
        self.slo.report()
        lines = self.serving_metrics.render().splitlines()
        lines.extend(flattened_stats_lines(stats, set(self.serving_metrics.registry._metrics)))
        lines += ["# TYPE ditl_serving_up gauge", "ditl_serving_up 1"]
        body = ("\n".join(lines) + "\n").encode()
        self.send_response(200)
        self.send_header("Content-Type", "text/plain; version=0.0.4")
        self.send_header("X-Request-Id", self._request_id())
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _spec_acceptance(self):
        """The lock-step speculative generator's acceptance: the auto
        generator's EMA, else the last call's (None before any)."""
        spec = self.spec_generator
        acc = getattr(spec, "acceptance_ema", None)
        if acc is None:
            acc = getattr(getattr(spec, "spec", spec), "last_acceptance", None)
        return acc

    def _observe_lockstep(self, t0: float, n_gen: int) -> None:
        """Telemetry of a request the lock-step Generator served (the
        continuous engine records its own): the request, completion and
        token counters and the end-to-end latency; queue wait, TTFT and
        TPOT have no lock-step counterpart."""
        m = self.serving_metrics
        m.requests.inc()
        m.completed.inc()
        m.tokens_generated.inc(n_gen)
        m.e2e.observe(time.time() - t0)

    def do_POST(self):
        self._rid = None  # a fresh id per request on a kept-alive connection
        try:
            raw = self.rfile.read(int(self.headers.get("Content-Length", 0)))
        except (ValueError, OSError) as e:
            # Unread body bytes would desync the kept-alive connection.
            self.close_connection = True
            self._send_json(400, {"error": {"message": f"bad request: {e}"}})
            return
        path = self.path.rstrip("/")
        try:
            payload = json.loads(raw or b"{}")
        except ValueError as e:
            self._send_json(400, {"error": {"message": f"bad request: {e}"}})
            return
        if not isinstance(payload, dict):
            self._send_json(400, {"error": {"message": "body must be a JSON object"}})
        elif path.endswith(("/chat/completions", "/completions", "/embeddings")):
            self._device_work(payload, path)
        else:
            self._send_json(404, {"error": {"message": f"no route {self.path}"}})

    def _device_work(self, payload: dict, path: str) -> None:
        """Admission: 503 while draining, 429 beyond ``max_pending`` in flight."""
        srv = self.server
        if srv.draining:
            self._send_json(503, {"error": {
                "message": "server is draining; retry on another replica",
                "type": "unavailable_error"}})
            return
        n = srv._enter_request()
        try:
            if self.max_pending is not None and n > self.max_pending:
                self.serving_metrics.queue_full.inc()
                self._send_429(f"server at capacity ({self.max_pending} requests in flight)")
                return
            if path.endswith("/embeddings"):
                try:
                    self._embeddings(payload)
                except Exception as e:  # noqa: BLE001 - the server keeps serving
                    logger.exception("embeddings failed")
                    self._send_json(500, {"error": {"message": str(e)}})
            else:
                self._complete(payload, chat=path.endswith("/chat/completions"))
        finally:
            srv._exit_request()
            self._sample_service_rate()

    def _deadline(self, payload: dict):
        """The request's deadline: the ``deadline_s`` field, else the
        ``X-Request-Deadline-S`` header. Returns (deadline_s or None, from
        the header), or None after answering 400 (not a number) or 504 (at
        or below 0: expired before any work)."""
        deadline_s = payload.get("deadline_s")
        from_header = False
        if deadline_s is None:
            deadline_s = self.headers.get("X-Request-Deadline-S")
            from_header = deadline_s is not None
        if deadline_s is None:
            return None, False
        try:
            deadline_s = float(deadline_s)
        except (TypeError, ValueError):
            deadline_s = float("nan")
        if deadline_s != deadline_s:  # NaN would never expire
            self._send_json(400, {"error": {"message": "deadline_s must be a number (seconds)"}})
            return None
        if deadline_s <= 0:
            self.serving_metrics.deadline_expired.inc()
            self._send_json(504, {"error": {"message": "deadline expired before any work began",
                                            "type": "timeout_error"}})
            return None
        return deadline_s, from_header

    def _slo_class(self, payload: dict):
        """The request's SLO class: the ``X-SLO-Class`` header, which wins,
        else the ``slo_class`` field. Returns (class or None, from the
        header), or None after answering 400 for an unknown class or one
        this server's engine cannot honour (``_gate_slo_class``)."""
        slo_class = self.headers.get("X-SLO-Class")
        from_header = slo_class is not None
        if slo_class is None:
            slo_class = payload.get("slo_class")
        if slo_class is None:
            return None, False
        if slo_class not in SLO_CLASSES:
            self._send_json(400, {"error": {"message":
                f"unknown slo_class {slo_class!r} (one of {sorted(SLO_CLASSES)})"}})
            return None
        if self.threaded_engine is None:
            ok, slo_class = self._gate_slo_class(slo_class, from_header)
            if not ok:
                return None
        return slo_class, from_header

    def _gate_slo_class(self, slo_class, from_header: bool):
        """A path that cannot order by class (the lock-step engine, or a
        logprob request beyond ``--logprobs-k``): a header's class is
        dropped, a payload's class other than ``interactive`` answers 400.
        Returns (ok, the class to pass on)."""
        if slo_class in (None, "interactive"):
            return True, slo_class
        if from_header:
            return True, None
        self._send_json(400, {"error": {"message":
            "slo_class requires the continuous-engine serving path (no lockstep or pod "
            "engine, adapter fallback, or logprobs beyond --logprobs-k)"}})
        return False, None

    def _complete(self, payload: dict, *, chat: bool) -> None:
        """A completion under a ``server.request`` span that continues the
        client's W3C ``traceparent`` (or roots a fresh trace); the engine's
        spans chain under it through ``submit(trace=...)``, and it covers
        the SSE writes of a stream."""
        self._span = self.tracer.start_span(
            "server.request", parent=parse_traceparent(self.headers.get("traceparent")),
            request_id=self._request_id(), route="chat" if chat else "completions")
        try:
            self._complete_request(payload, chat=chat)
        finally:
            self._span.end()

    def _complete_request(self, payload: dict, *, chat: bool) -> None:
        tok = self.generator.tokenizer
        try:
            if chat:
                prompt = _chat_prompt(payload.get("messages") or [])
            else:
                prompt = payload.get("prompt") or ""
                if isinstance(prompt, list):
                    prompt = prompt[0] if prompt else ""
                if not isinstance(prompt, str):
                    raise ValueError("prompt must be a string")
            seed = payload.get("seed")
            if seed is None:  # fresh draws unless the client pins a seed
                seed = random.getrandbits(31)
            gen = GenerateConfig(
                max_new_tokens=int(payload.get("max_tokens") or self.default_max_tokens),
                temperature=float(payload.get("temperature") or 0.0),
                top_p=float(payload.get("top_p") or 1.0),
                seed=int(seed),
            )
            if gen.max_new_tokens < 1:
                raise ValueError("max_tokens must be >= 1")
            # OpenAI logprobs: completions' `logprobs: N` (0 is a real
            # request, so test presence), chat's `logprobs: true` with
            # `top_logprobs: N`. N is clamped to 20.
            lp_req = payload.get("logprobs")
            n_top = None
            if lp_req is not None and lp_req is not False:
                top = payload.get("top_logprobs") if chat else lp_req
                n_top = max(0, min(int(top) if top is not None else 1, 20))
        except (TypeError, ValueError) as e:
            self._send_json(400, {"error": {"message": str(e)}})
            return
        # The reference's order of refusals: deadline, SLO class, stop,
        # guided decoding, n/best_of.
        deadline = self._deadline(payload)
        slo = deadline and self._slo_class(payload)
        if not slo:
            return
        (deadline_s, deadline_from_header), (slo_class, slo_from_header) = deadline, slo
        try:
            stops = _stop_list(payload.get("stop"))
        except ValueError as e:
            self._send_json(400, {"error": {"message": str(e)}})
            return
        try:
            grammar = self._resolve_grammar(payload)
        except ValueError as e:
            self._send_json(400, {"error": {"message": str(e)}})
            return
        try:
            n_choices = int(payload.get("n") or 1)
            best_of = int(payload.get("best_of") or n_choices)
        except (TypeError, ValueError):
            self._send_json(400, {"error": {"message": "n and best_of must be integers"}})
            return
        engine = self.threaded_engine
        if deadline_s is not None and not (engine is not None
                                           and n_choices == 1 and best_of == 1):
            # Only the continuous engine's single-choice path evicts on a
            # deadline: elsewhere a payload deadline answers 400 and the
            # header's (a gateway's hint) is dropped.
            if not deadline_from_header:
                self._send_json(400, {"error": {"message":
                    "deadline_s requires the continuous-engine single-choice serving path "
                    "(no lockstep/pod engine, adapter fallback, or n/best_of)"}})
                return
            deadline_s = None
        prompt_ids = [tok.bos_id] + tok.encode(prompt)
        if n_choices > 1 or best_of > 1:
            if not 1 <= n_choices <= best_of <= 8:
                msg = "need 1 <= n <= best_of <= 8"
            elif payload.get("stream"):
                msg = "n/best_of do not compose with stream"
            elif n_top is not None:
                msg = "logprobs with n > 1 is not supported"
            else:
                self._multi_complete(payload, prompt_ids, gen, chat=chat, n=n_choices,
                                     best_of=best_of, stops=stops, slo_class=slo_class,
                                     slo_from_header=slo_from_header, grammar=grammar)
                return
            self._send_json(400, {"error": {"message": msg}})
            return
        engine_k = engine.logprobs_k if engine is not None else 0
        if payload.get("stream"):
            if n_top is not None and not (0 < engine_k and n_top <= engine_k and not stops):
                self._send_json(400, {"error": {"message":
                    "streaming logprobs requires --engine continuous with "
                    "--logprobs-k >= N, no stop sequences, and no adapter "
                    "routing"}})
                return
            try:
                self._stream_complete(payload, prompt, prompt_ids, gen, chat=chat,
                                      stops=stops, lp_n=n_top, deadline_s=deadline_s,
                                      slo_class=slo_class, grammar=grammar)
            except QueueFullError as e:
                # The stream's submit is eager (before the SSE headers), so a
                # full queue is still a real 429.
                self._span.annotate(error=type(e).__name__)
                self._send_429(str(e))
            except ValueError as e:
                # the eager submit's validation; a grammar table out of rows
                # is the server's capacity, not the client's fault
                status = 503 if "fsm_capacity" in str(e) else 400
                self._send_json(status, {"error": {"message": str(e)}})
            except OSError:
                logger.info("client disconnected mid-stream")
            except Exception:  # noqa: BLE001 - the headers may be out already:
                # a JSON 500 would corrupt the stream; log and close.
                logger.exception("streaming completion failed")
            return
        # Logprob requests ride the continuous engine up to --logprobs-k
        # alternatives; beyond it (or without it) the lock-step Generator
        # serves them, where no class orders the work.
        lp_lockstep = n_top is not None and not (0 < engine_k and n_top <= engine_k)
        if lp_lockstep and grammar is not None:
            # guided requests never fall back to the lock-step Generator (it
            # has no grammar masks)
            self._send_json(400, {"error": {"message":
                "guided decoding with logprobs requires the continuous engine armed "
                "with --logprobs-k >= N"}})
            return
        if lp_lockstep:
            ok, slo_class = self._gate_slo_class(slo_class, slo_from_header)
            if not ok:
                return
        t0 = time.time()
        lp = None
        try:
            if engine is not None and n_top is not None and not lp_lockstep:
                out, lp = engine.generate_one_with_logprobs(
                    prompt_ids, n_top, max_new_tokens=gen.max_new_tokens,
                    temperature=gen.temperature, top_p=gen.top_p, seed=gen.seed,
                    slo_class=slo_class, deadline_s=deadline_s, grammar=grammar,
                    trace=self._span)
            elif engine is not None and n_top is None:
                # Continuous engine: the request shares decode ticks.
                out = engine.generate_one(
                    prompt_ids, max_new_tokens=gen.max_new_tokens,
                    temperature=gen.temperature, top_p=gen.top_p, seed=gen.seed,
                    slo_class=slo_class, deadline_s=deadline_s, grammar=grammar,
                    trace=self._span)
            else:
                if n_top is None:
                    out = self._lockstep_generate(prompt_ids, gen)
                else:
                    with self.device_lock:
                        # The engine's top-k needs k >= 1; N = 0 computes one
                        # alternative and emits none.
                        outs, lps = self.generator.generate_tokens_with_logprobs(
                            [prompt_ids], dataclasses.replace(gen, logprobs=max(1, n_top)))
                    out, lp = outs[0], lps[0]
                # before the response write: a scrape right after it sees it
                self._observe_lockstep(t0, len(out))
            self._count(len(prompt_ids), len(out))
        except Exception as e:  # noqa: BLE001 - the server keeps serving
            self._send_error(e)
            return
        n_gen = len(out)
        text, hit_stop = _apply_stop(tok.decode(out), stops)
        # "length" = the generated token count hit the budget.
        finish = "stop" if hit_stop or n_gen < gen.max_new_tokens else "length"
        choice = self._choice(0, text, finish, chat)
        if lp is not None:
            choice["logprobs"] = _logprobs_json(tok, out, lp, text, hit_stop,
                                                n_top, chat, len(prompt))
        self._send_json(200, self._body(payload, t0, chat, [choice], len(prompt_ids), n_gen))
        logger.info("served %d prompt + %d completion tokens in %.2fs",
                    len(prompt_ids), n_gen, time.time() - t0)

    def _resolve_grammar(self, payload: dict):
        """The request's guided-decoding spec (``guided_regex``,
        ``guided_json``, or ``response_format`` json_object / json_schema)
        compiled into a ``CompiledGrammar``, LRU-cached by spec (compiling is
        host work a repeat client should not pay twice; the engine also
        deduplicates registration by table content). None for an
        unconstrained request; raises ValueError (the caller's 400) for more
        than one spec, a server not armed for guided decoding or a bad
        spec."""
        rf = payload.get("response_format")
        rf = rf if isinstance(rf, dict) else {}
        specs = [payload.get("guided_regex") is not None,
                 payload.get("guided_json") is not None,
                 rf.get("type") in ("json_object", "json_schema")]
        if not any(specs):
            return None
        if sum(specs) > 1:
            raise ValueError("at most one of guided_regex, guided_json, response_format "
                             "may constrain a request")
        eng = self.threaded_engine
        if eng is None or not eng.guided:
            raise ValueError(
                "guided decoding requires --engine continuous with --fsm-capacity > 0")
        tok = eng.tokenizer
        from ditl_tpu_torch.infer import grammar as G

        if payload.get("guided_regex") is not None:
            pattern = payload["guided_regex"]
            if not isinstance(pattern, str):
                raise ValueError("guided_regex must be a string")
            key, build = ("regex", pattern), (lambda: G.compile_regex(pattern, tok))
        elif payload.get("guided_json") is not None:
            schema = payload["guided_json"]
            if isinstance(schema, str):
                schema = json.loads(schema)
            if not isinstance(schema, dict):
                raise ValueError("guided_json must be a JSON-schema object")
            key = ("schema", json.dumps(schema, sort_keys=True))
            build = lambda: G.compile_json_schema(schema, tok)  # noqa: E731
        elif rf.get("type") == "json_schema":
            schema = (rf.get("json_schema") or {}).get("schema")
            if not isinstance(schema, dict):
                raise ValueError("response_format.json_schema.schema must be an object")
            key = ("schema", json.dumps(schema, sort_keys=True))
            build = lambda: G.compile_json_schema(schema, tok)  # noqa: E731
        else:  # json_object
            key, build = ("json_object",), (lambda: G.compile_json(tok))
        with self.grammar_lock:
            if key in self.grammar_cache:
                self.grammar_cache.move_to_end(key)
                return self.grammar_cache[key]
        g = build()  # outside the lock: a compile can take seconds
        with self.grammar_lock:
            self.grammar_cache[key] = g
            while len(self.grammar_cache) > 64:
                self.grammar_cache.popitem(last=False)
        return g

    def _send_error(self, e: Exception) -> None:
        """A failed generation as its status: 429 for a full queue, 504 for
        a deadline the engine enforced, 503 for a grammar the table has no
        rows left for, 400 for a request the engine refused
        (``BadRequestError``: prompt + max_tokens beyond the context, a pool
        too small), else 500."""
        self._span.annotate(error=type(e).__name__)
        if isinstance(e, QueueFullError):
            self._send_429(str(e))
        elif isinstance(e, DeadlineExceededError):
            self._send_json(504, {"error": {"message": str(e), "type": "timeout_error"}})
        elif isinstance(e, ValueError) and "fsm_capacity exhausted" in str(e):
            # Rows are never evicted (live slots may point anywhere in the
            # table): registered grammars still serve, new ones wait for a
            # restart.
            self._send_json(503, {"error": {"message":
                str(e) + " (new grammars need a restart with a larger --fsm-capacity; "
                "already-registered grammars still serve)"}})
        elif isinstance(e, ValueError):
            self._send_json(400, {"error": {"message": str(e)}})
        else:
            logger.error("completion failed", exc_info=e)
            self._send_json(500, {"error": {"message": str(e)}})

    def _count(self, n_prompt: int, n_gen: int) -> None:
        with self.stats_lock:
            self.stats["requests"] += 1
            self.stats["prompt_tokens"] += n_prompt
            self.stats["completion_tokens"] += n_gen

    @staticmethod
    def _choice(i: int, text: str, finish: str, chat: bool) -> dict:
        if chat:
            return {"index": i, "message": {"role": "assistant", "content": text},
                    "finish_reason": finish}
        return {"index": i, "text": text, "finish_reason": finish}

    def _body(self, payload: dict, t0: float, chat: bool, choices: list, n_prompt: int,
              n_gen: int) -> dict:
        return {"id": f"cmpl-{uuid.uuid4().hex[:24]}",
                "object": "chat.completion" if chat else "text_completion",
                "created": int(t0), "model": payload.get("model") or self.model_name,
                "choices": choices,
                "usage": {"prompt_tokens": n_prompt, "completion_tokens": n_gen,
                          "total_tokens": n_prompt + n_gen}}

    def _multi_complete(self, payload: dict, prompt_ids: list[int], gen: GenerateConfig, *,
                        chat: bool, n: int, best_of: int, stops: list[str],
                        slo_class, slo_from_header: bool, grammar=None) -> None:
        """OpenAI ``n``/``best_of``: ``best_of`` candidates, the best ``n``
        returned, ranked by mean token logprob when ``best_of > n``. The
        continuous engine runs the copies side by side
        (``ThreadedEngine.generate_many``, copy i seeded
        ``derive_copy_seed(seed, i)``; ranking needs ``--logprobs-k``); the
        lock-step Generator takes them as one batch (not a guided request:
        400). Usage counts every candidate's tokens."""
        t0 = time.time()
        rank = best_of > n
        engine = self.threaded_engine
        try:
            if engine is not None and (not rank or engine.logprobs_k > 0):
                reqs = engine.generate_many(
                    prompt_ids, best_of, max_new_tokens=gen.max_new_tokens,
                    temperature=gen.temperature, top_p=gen.top_p, seed=gen.seed,
                    slo_class=slo_class, logprobs=0 if rank else None, grammar=grammar,
                    trace=self._span)
                cands = [(r.tokens, r.lp_token) for r in reqs]
            else:
                ok, slo_class = self._gate_slo_class(slo_class, slo_from_header)
                if not ok:
                    return
                if grammar is not None:
                    # the missing piece named: a guided request lands here on
                    # a guided engine when ranking needs logprobs it lacks
                    self._send_json(400, {"error": {"message":
                        "best_of ranking with guided decoding requires the continuous "
                        "engine armed with --logprobs-k >= 1"
                        if engine is not None and rank and engine.logprobs_k == 0
                        else "guided decoding requires the continuous engine"}})
                    return
                batch = [list(prompt_ids) for _ in range(best_of)]
                with self.device_lock:
                    if rank:
                        outs, lps = self.generator.generate_tokens_with_logprobs(
                            batch, dataclasses.replace(gen, logprobs=1))
                        cands = [(o, lp["token_logprobs"]) for o, lp in zip(outs, lps)]
                    else:
                        cands = [(o, None) for o in self.generator.generate_tokens(batch, gen)]
                self._observe_lockstep(t0, sum(len(out) for out, _ in cands))
        except Exception as e:  # noqa: BLE001 - the server keeps serving
            self._send_error(e)
            return
        if rank:
            cands.sort(key=lambda c: (sum(c[1][: len(c[0])]) / max(1, len(c[0]))) if c[1]
                       else 0.0, reverse=True)
        total = sum(len(out) for out, _ in cands)
        tok = self.generator.tokenizer
        choices = []
        for i, (out, _) in enumerate(cands[:n]):
            text, hit_stop = _apply_stop(tok.decode(out), stops)
            choices.append(self._choice(
                i, text, "stop" if hit_stop or len(out) < gen.max_new_tokens else "length",
                chat))
        self._count(len(prompt_ids), total)
        self._send_json(200, self._body(payload, t0, chat, choices, len(prompt_ids), total))

    def _send_sse(self, events) -> None:
        """Send JSON events as Server-Sent Events. SSE has no
        Content-Length, so the connection closes after ``data: [DONE]``. A
        client that vanishes mid-stream (a failed write) closes the events
        generator, whose ``finally`` cancels the generation and frees the
        slot instead of decoding the abandoned budget."""
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("X-Request-Id", self._request_id())
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Connection", "close")  # also sets close_connection
        self.end_headers()
        try:
            for event in events:
                self.wfile.write(f"data: {json.dumps(event)}\n\n".encode())
                self.wfile.flush()
            self.wfile.write(b"data: [DONE]\n\n")
            self.wfile.flush()
        except OSError:  # BrokenPipeError and ConnectionError are subclasses
            self.serving_metrics.client_disconnects.inc()
            logger.info("client disconnected mid-stream; cancelling its generation")
        finally:
            events.close()

    def _stream_complete(self, payload: dict, prompt: str, prompt_ids: list[int],
                         gen: GenerateConfig, *, chat: bool, stops: list[str],
                         lp_n: int | None = None, deadline_s: float | None = None,
                         slo_class: str | None = None, grammar=None) -> None:
        """OpenAI streaming: incremental chunks from the continuous engine;
        the lock-step engine generates fully, then sends one chunk. The
        finish chunk says ``"stop"`` when a stop sequence matched (even at
        the full token budget) or the generation ended early (a deadline's
        eviction too), else ``"length"``. ``lp_n`` (continuous engine,
        checked by the caller): each chunk also carries its tokens' logprobs
        in the reference's layout, their ``text_offset`` counted through the
        stream."""
        cmpl_id = f"cmpl-{uuid.uuid4().hex[:24]}"
        created = int(time.time())
        model = payload.get("model") or self.model_name
        kind = "chat.completion.chunk" if chat else "text_completion"

        def event(text, finish=None, role=None, logprobs=None):
            if chat:
                delta = {}
                if role is not None:
                    delta = {"role": role, "content": ""}
                elif text:
                    delta = {"content": text}
                choice = {"index": 0, "delta": delta, "finish_reason": finish}
            else:
                choice = {"index": 0, "text": text, "finish_reason": finish}
            if logprobs is not None:
                choice["logprobs"] = logprobs
            return {"id": cmpl_id, "object": kind, "created": created,
                    "model": model, "choices": [choice]}

        # Submit before the SSE headers: QueueFullError is still a 429 and
        # a request the context cannot hold a 400. The lock-step engine
        # generates whole here, for the same reason (the reference does it
        # after the headers, where its error would corrupt the stream).
        stream_iter = out = None
        engine = self.threaded_engine
        if engine is not None:
            kw = dict(max_new_tokens=gen.max_new_tokens, temperature=gen.temperature,
                      top_p=gen.top_p, seed=gen.seed, slo_class=slo_class,
                      deadline_s=deadline_s, grammar=grammar, trace=self._span)
            stream_iter = (engine.stream_one(prompt_ids, **kw) if lp_n is None
                           else engine.stream_one_with_logprobs(prompt_ids, lp_n, **kw))
        else:
            # Generated whole, so greedy streams take speculation as
            # non-streamed requests do.
            t0 = time.time()
            out = self._lockstep_generate(prompt_ids, gen)
            self._observe_lockstep(t0, len(out))

        def events():
            try:
                if chat:
                    yield event("", role="assistant")
                tracker = _StopTracker(stops)
                n_gen = 0
                if stream_iter is not None:
                    tok = engine.tokenizer
                    detok = _Detokenizer(tok)
                    offset = len(prompt)
                    for chunk in stream_iter:
                        lpj = None
                        if lp_n is not None:  # no stops here (the caller's rule)
                            chunk, stats = chunk
                            lpj = _logprobs_json(tok, chunk, stats, "", False, lp_n, chat,
                                                 offset)
                            offset += sum(len(tok.decode([t])) for t in chunk)
                        n_gen += len(chunk)
                        text = tracker.push(detok.push(chunk))
                        if text or lpj is not None:
                            yield event(text, logprobs=lpj)
                        if tracker.hit:
                            break  # closing stream_iter cancels the request
                    tail = tracker.push(detok.flush()) + tracker.flush()
                    if tail:
                        yield event(tail)
                else:
                    n_gen = len(out)
                    text, tracker.hit = _apply_stop(
                        self.generator.tokenizer.decode(out), stops)
                    if text:
                        yield event(text)
                self._count(len(prompt_ids), n_gen)
                finish = "stop" if tracker.hit or n_gen < gen.max_new_tokens else "length"
                yield event("", finish=finish)
            finally:
                if stream_iter is not None:
                    stream_iter.close()

        self._send_sse(events())

    def _embeddings(self, payload: dict) -> None:
        """OpenAI ``/v1/embeddings``: mean-pooled, unit-length final hidden
        states. The batch is padded to a power of two and each input to the
        longest's power of two (``_next_pow2``), as the reference pads for
        its compiled programs; eager PyTorch compiles nothing, so the
        reference's cache of programs has no counterpart. One forward under
        the device lock."""
        import torch

        from ditl_tpu_torch.models import llama

        raw = payload.get("input")
        if isinstance(raw, str):
            inputs = [raw]
        elif isinstance(raw, list) and raw and all(isinstance(x, int) for x in raw):
            inputs = [raw]  # one pre-tokenized prompt
        elif isinstance(raw, list):
            inputs = raw
        else:
            self._send_json(400, {"error": {"message":
                "input must be a string, array of strings, or token array"}})
            return
        if not inputs or len(inputs) > 64:
            self._send_json(400, {"error": {"message":
                "input must contain 1..64 entries"}})
            return
        gen = self.generator
        tok, cfg = gen.tokenizer, gen.cfg
        token_lists = []
        for item in inputs:
            if isinstance(item, str):
                ids = [tok.bos_id] + tok.encode(item)
            elif isinstance(item, list) and all(isinstance(x, int) for x in item):
                ids = item or [tok.bos_id]
            else:
                self._send_json(400, {"error": {"message":
                    "each input must be a string or a token-id array"}})
                return
            token_lists.append(ids[: cfg.max_seq_len])
        if any(not 0 <= t < cfg.vocab_size for ids in token_lists for t in ids):
            self._send_json(400, {"error": {"message":
                f"token ids must lie in [0, {cfg.vocab_size})"}})
            return
        batch = _next_pow2(len(token_lists), floor=1)
        plen = _next_pow2(max(len(t) for t in token_lists))
        ids = torch.full((batch, plen), tok.pad_id, dtype=torch.long)
        lengths = torch.ones((batch,), dtype=torch.long)
        for i, t in enumerate(token_lists):
            ids[i, : len(t)] = torch.tensor(t, dtype=torch.long)
            lengths[i] = len(t)
        dev = gen.device
        with self.device_lock:
            ids, lengths = ids.to(dev), lengths.to(dev)
            q_pos = torch.arange(plen, device=dev)
            seg = (q_pos[None, :] < lengths[:, None]).to(torch.int32)
            hidden = llama.forward(gen.params, ids, cfg, positions=q_pos.expand(batch, plen),
                                   segment_ids=seg, return_hidden=True)
            mask = seg.float()[..., None]
            pooled = (hidden.float() * mask).sum(1) / mask.sum(1)
            norm = pooled.norm(dim=-1, keepdim=True)
            vecs = (pooled / norm.clamp_min(1e-9)).cpu()
        n_tokens = sum(len(t) for t in token_lists)
        self._send_json(200, {
            "object": "list",
            "model": payload.get("model") or self.model_name,
            "data": [{"object": "embedding", "index": i, "embedding": vecs[i].tolist()}
                     for i in range(len(token_lists))],
            "usage": {"prompt_tokens": n_tokens, "total_tokens": n_tokens},
        })


    def _lockstep_generate(self, prompt_ids: list[int], gen: GenerateConfig) -> list[int]:
        """One lock-step generation, speculatively when eligible: greedy, and
        the speculative program's k + 1 slack fits the context (its
        ValueError falls back to the plain Generator). The tokens are the
        same by the speculation exactness contract."""
        if self.spec_generator is not None and gen.temperature == 0.0:
            try:
                with self.device_lock:
                    return self.spec_generator.generate_tokens(
                        [prompt_ids], gen.max_new_tokens)[0]
            except ValueError:
                pass
        with self.device_lock:
            return self.generator.generate_tokens([prompt_ids], gen)[0]


def _logprobs_json(tok, ids: list[int], lp: dict, text: str, hit_stop: bool,
                   n_top: int, chat: bool, text_offset: int) -> dict:
    """OpenAI logprobs for the returned tokens. With a stop hit, only the
    whole tokens inside the cut text are kept, so entries stay aligned with
    the text."""
    if hit_stop:
        keep, acc = 0, ""
        for t in ids:
            piece = tok.decode([t])
            if len(acc) + len(piece) > len(text):
                break
            acc += piece
            keep += 1
        ids = ids[:keep]
    strs = [tok.decode([t]) for t in ids]
    chosen = lp["token_logprobs"][:len(ids)]
    tops = [list(zip(lp["top_ids"][i][:n_top], lp["top_logprobs"][i][:n_top]))
            for i in range(len(ids))]
    if chat:
        return {"content": [
            {"token": s, "logprob": chosen[i],
             "top_logprobs": [{"token": tok.decode([tid]), "logprob": tlp}
                              for tid, tlp in tops[i]]}
            for i, s in enumerate(strs)]}
    offsets, pos = [], text_offset
    for s in strs:
        offsets.append(pos)
        pos += len(s)
    return {"tokens": strs, "token_logprobs": chosen,
            "top_logprobs": [{tok.decode([tid]): tlp for tid, tlp in top}
                             for top in tops],
            "text_offset": offsets}


def make_server(
    generator: Generator,
    *,
    threaded_engine: ThreadedEngine | None = None,
    spec_generator=None,
    host: str = "127.0.0.1",
    port: int = 8300,
    model_name: str = "ditl-tpu-torch",
    default_max_tokens: int = 64,
    max_pending: int | None = None,
    serving_metrics: ServingMetrics | None = None,
    tracer: Tracer | None = None,
    slo: BurnRateMonitor | None = None,
    telemetry=None,
) -> DrainableHTTPServer:
    """Build (not start) the HTTP server; ``port=0`` picks a free port.
    ``threaded_engine`` (already built, over ``generator``'s weights) serves
    completions through the continuous engine; ``generator`` then serves
    only logprob requests. ``spec_generator`` (a ``SpeculativeGenerator``
    or ``AutoSpeculativeGenerator``) serves the lock-step path's greedy
    requests. Closing the server stops the engine.

    Telemetry, with the reference's defaults: ``serving_metrics`` (default
    the continuous engine's bundle, so ``/metrics`` renders what its
    scheduler recorded, else a fresh one the lock-step paths record into),
    ``tracer`` (default the engine's, else unarmed) and ``slo`` (default a
    burn-rate monitor over the bundle, its objectives from ``telemetry``,
    a ``config.TelemetryConfig``, else the defaults; it samples only when
    ``/slo`` or ``/metrics`` is scraped, so the server always has one)."""
    if serving_metrics is None:
        serving_metrics = getattr(threaded_engine, "metrics", None)
    if serving_metrics is None:
        serving_metrics = ServingMetrics()
    if tracer is None:
        tracer = getattr(threaded_engine, "tracer", None) or NULL_TRACER
    if slo is None:
        kw = telemetry.serving_slo_kwargs() if telemetry is not None else {}
        slo = serving_slo(serving_metrics, **kw)
    handler = type("BoundHandler", (_Handler,), {
        "generator": generator,
        "threaded_engine": threaded_engine,
        "spec_generator": spec_generator,
        "model_name": model_name,
        "device_lock": threading.Lock(),
        "default_max_tokens": default_max_tokens,
        "max_pending": max_pending,
        "stats": {"requests": 0, "prompt_tokens": 0, "completion_tokens": 0},
        "stats_lock": threading.Lock(),
        "grammar_cache": collections.OrderedDict(),
        "grammar_lock": threading.Lock(),
        "serving_metrics": serving_metrics,
        "tracer": tracer,
        "slo": slo,
    })
    server = DrainableHTTPServer((host, port), handler)
    server.engine = threaded_engine
    return server


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="ditl_tpu_torch.infer.server")
    p.add_argument("--preset", default=None)
    p.add_argument("--override", action="append", default=[],
                   help="ModelConfig FIELD=VALUE (repeatable), e.g. "
                   "attention_impl=flash")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--seed", type=int, default=0, help="weight-init seed")
    p.add_argument("--checkpoint-dir", default="",
                   help="serve the newest verified training checkpoint in this "
                   "directory (train.checkpoint_dir of the run)")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8300)
    p.add_argument("--max-tokens", type=int, default=64)
    p.add_argument("--max-pending", type=int, default=0,
                   help="cap on in-flight completions (429 beyond); 0 = none")
    p.add_argument("--engine", choices=("lockstep", "continuous"), default="lockstep")
    p.add_argument("--cache-mode", choices=("contiguous", "paged"), default="contiguous",
                   help="KV cache layout for --engine continuous: 'contiguous' (one "
                   "max-context row per slot; register_prefix keeps shared prefixes) "
                   "or 'paged' (a shared page pool with automatic prefix reuse)")
    p.add_argument("--slots", type=int, default=8,
                   help="decode slots for --engine continuous")
    p.add_argument("--prefill-chunk", type=int, default=0,
                   help="chunked prefill for --engine continuous: prompts longer than "
                   "this prefill one chunk per tick, interleaved with in-flight "
                   "decodes (under --cache-mode paged a multiple of --page-size; "
                   "0 = whole-prompt prefill)")
    p.add_argument("--token-budget", type=int, default=0,
                   help="per-tick token budget for --engine continuous: each tick "
                   "spends at most budget - decode_ready x decode_chunk tokens on "
                   "prefill, so long prompts cannot stall decoding streams (pair with "
                   "--prefill-chunk). Must cover one full decode tick (slots x 16); "
                   "0 = unbudgeted")
    p.add_argument("--page-size", type=int, default=256,
                   help="tokens per KV page for --cache-mode paged")
    p.add_argument("--pages", type=int, default=0,
                   help="page-pool size for --cache-mode paged; 0 = the contiguous "
                   "equivalent (slots x max context)")
    p.add_argument("--max-cache-len", type=int, default=0,
                   help="per-slot context cap for --engine continuous; 0 = model "
                   "max_seq_len")
    p.add_argument("--max-queue", type=int, default=0,
                   help="admission-queue depth cap for --engine continuous; beyond "
                   "it requests get HTTP 429 (0 = unbounded)")
    p.add_argument("--admission", choices=("reserve", "optimistic"), default="reserve",
                   help="paged admission policy: 'reserve' books worst-case pages "
                   "(prompt+max_tokens) up front; 'optimistic' books prompt + one tick, "
                   "feeds pages per tick, and preempts the youngest request on pool "
                   "exhaustion (exact resume): more concurrency when clients set "
                   "pessimistic max_tokens")
    p.add_argument("--logprobs-k", type=int, default=0,
                   help="arm the continuous engine to serve per-token logprobs with up "
                   "to K alternatives natively (requests ride ordinary decode ticks); "
                   "0 = logprob requests fall back to the lock-step generator")
    p.add_argument("--fsm-capacity", type=int, default=0,
                   help="arm guided (grammar-constrained) decoding on --engine "
                   "continuous: total DFA states servable at once (device table rows; "
                   "a JSON grammar is ~1.1k states at depth 5, a typical regex tens). "
                   "Requests then accept guided_regex / guided_json / response_format "
                   "json_object. 0 = off")
    p.add_argument("--quantize", choices=("none", "int8"), default="none",
                   help="weight-only int8 (halves the weights' memory; decode reads "
                   "stay bf16-sized until a fused int8 product; ops/quant.py)")
    p.add_argument("--kv-quant", choices=("none", "int8"), default="none",
                   help="int8 KV cache (halves cache reads/footprint against bf16 or "
                   "float16, a quarter against float32; composes with both cache modes "
                   "and every --override dtype)")
    p.add_argument("--speculative", choices=("off", "on", "auto"), default="off",
                   help="prompt-lookup speculative decoding: 'on' always speculates, "
                   "'auto' decides from measured acceptance. Continuous engine: "
                   "speculative decode ticks for greedy and sampled requests (greedy "
                   "outputs token-identical; sampled exact in distribution by "
                   "rejection sampling). Lock-step engine: greedy requests through "
                   "infer/speculative.py")
    p.add_argument("--draft-preset", default="",
                   help="model-based speculation (--speculative on|auto --engine "
                   "continuous): preset of a small draft model whose greedy "
                   "predictions draft for the target's verify forwards (same vocab); "
                   "every tick speculates. Pair with --draft-checkpoint for trained "
                   "weights (seed-initialised without it: smoke tests only)")
    p.add_argument("--draft-checkpoint", default="",
                   help="training checkpoint directory holding --draft-preset's weights")
    p.add_argument("--trace-dir", default="",
                   help="arm end-to-end request tracing: span records (server.request "
                   "and the continuous engine's queue/prefill/decode spans, tick "
                   "instants) append to DIR/events-server-<pid>.jsonl; export with "
                   "python -m ditl_tpu_torch.telemetry.trace_export --dir DIR")
    p.add_argument("--telemetry-override", action="append", default=[],
                   metavar="FIELD=VALUE",
                   help="TelemetryConfig override (repeatable), e.g. slo_ttft_s=0.5 or "
                   "journal_max_mb=64: the /slo objectives and the trace journal's "
                   "rotation cap")
    return p


def telemetry_from_args(args: argparse.Namespace) -> tuple:
    """(``config.TelemetryConfig``, tracer or None) of a parsed command
    line: the ``--telemetry-override`` fields and, with ``--trace-dir``, a
    tracer over ``DIR/events-server-<pid>.jsonl`` whose rotation cap is the
    config's ``journal_max_mb``."""
    import os

    from ditl_tpu_torch.config import Config, parse_overrides
    from ditl_tpu_torch.telemetry.journal import EventJournal

    telemetry = parse_overrides(
        Config(), [f"telemetry.{o}" for o in args.telemetry_override]).telemetry
    tracer = None
    if args.trace_dir:
        tag = os.getpid()  # one journal per server process
        tracer = Tracer(EventJournal(
            os.path.join(args.trace_dir, f"events-server-{tag}.jsonl"),
            source=f"server-{tag}", max_bytes=telemetry.journal_max_bytes()))
    return telemetry, tracer


def create_server(argv: list[str] | None = None) -> DrainableHTTPServer:
    """Parse the CLI, build the model and the server (not started)."""
    from ditl_tpu_torch.config import ModelConfig, parse_model_overrides
    from ditl_tpu_torch.data.tokenizer import get_tokenizer
    from ditl_tpu_torch.models import llama
    from ditl_tpu_torch.models.presets import get_preset

    parser = _parser()
    args = parser.parse_args(argv)
    if args.fsm_capacity and args.engine != "continuous":
        parser.error("--fsm-capacity (guided decoding) requires --engine continuous: "
                     "grammar masks ride the slot scheduler's decode ticks")
    if args.draft_preset and (args.engine != "continuous" or args.speculative == "off"):
        parser.error("--draft-preset requires --engine continuous with --speculative "
                     "on|auto (the draft model drafts for speculative ticks)")
    if args.draft_checkpoint and not args.draft_preset:
        parser.error("--draft-checkpoint needs --draft-preset")
    if args.admission == "optimistic" and (args.engine != "continuous"
                                           or args.cache_mode != "paged"):
        parser.error("--admission optimistic requires --engine continuous --cache-mode "
                     "paged (only the page pool can be reclaimed mid-flight)")
    telemetry_cfg, tracer = telemetry_from_args(args)
    cfg = get_preset(args.preset) if args.preset else ModelConfig()
    cfg = parse_model_overrides(cfg, args.override)
    if args.kv_quant == "int8":
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    params = None
    restored = False  # a restore quantizes its masters itself
    if args.checkpoint_dir:
        from ditl_tpu_torch.train.checkpoint import CheckpointManager

        ckpt = CheckpointManager(args.checkpoint_dir)
        params = ckpt.restore_latest_params(
            cfg, llama.init_params(cfg, device="meta"), device=args.device,
            quantize=args.quantize == "int8")
        ckpt.close()
        if params is not None:
            logger.info("restored params from %s", args.checkpoint_dir)
            restored = True
    if params is None:
        params = llama.init_params(cfg, seed=args.seed, device=args.device)
    if args.quantize == "int8" and not restored:
        from ditl_tpu_torch.ops.quant import quantize_weights

        params = quantize_weights(params, tie_embeddings=cfg.tie_embeddings)
        logger.info("quantized weights to int8 (weight-only)")
    tokenizer = get_tokenizer("byte")
    generator = Generator(params, cfg, tokenizer, device=args.device)
    draft_params = draft_cfg = None
    if args.draft_preset:
        # the draft model in its preset's own dtype
        draft_cfg = get_preset(args.draft_preset)
        if draft_cfg.vocab_size != cfg.vocab_size:
            parser.error(f"--draft-preset vocab {draft_cfg.vocab_size} must match the "
                         f"target's {cfg.vocab_size} (same token space)")
        if args.draft_checkpoint:
            from ditl_tpu_torch.train.checkpoint import CheckpointManager

            ckpt = CheckpointManager(args.draft_checkpoint)
            draft_params = ckpt.restore_latest_params(
                draft_cfg, llama.init_params(draft_cfg, device="meta"), device=args.device)
            ckpt.close()
            if draft_params is None:
                parser.error(f"--draft-checkpoint: no checkpoint in {args.draft_checkpoint}")
            logger.info("restored draft params from %s", args.draft_checkpoint)
        else:
            draft_params = llama.init_params(draft_cfg, seed=1, device=args.device)
    threaded = None
    if args.engine == "continuous":
        from ditl_tpu_torch.infer.continuous import ContinuousEngine

        threaded = ThreadedEngine(ContinuousEngine(
            params, cfg, tokenizer, n_slots=args.slots,
            max_cache_len=args.max_cache_len or None,
            prefill_chunk=args.prefill_chunk, cache_mode=args.cache_mode,
            page_size=args.page_size, n_pages=args.pages or None,
            max_queue=args.max_queue or None, device=args.device,
            speculative=args.speculative != "off",
            # 'on' speculates every tick; 'auto' keeps the measured decision.
            spec_threshold=0.0 if args.speculative == "on" else None,
            draft_params=draft_params, draft_cfg=draft_cfg,
            token_budget=args.token_budget, admission=args.admission,
            logprobs_k=args.logprobs_k, fsm_capacity=args.fsm_capacity,
            tracer=tracer,
        ))
    spec = None
    if args.speculative != "off" and args.engine == "lockstep":
        from ditl_tpu_torch.infer.speculative import (
            AutoSpeculativeGenerator,
            SpeculativeGenerator,
        )

        spec = (AutoSpeculativeGenerator(params, cfg, tokenizer, plain=generator,
                                         device=args.device)
                if args.speculative == "auto"
                else SpeculativeGenerator(params, cfg, tokenizer, device=args.device))
    server = make_server(generator, threaded_engine=threaded, spec_generator=spec,
                         host=args.host,
                         port=args.port, model_name=cfg.name,
                         default_max_tokens=args.max_tokens,
                         max_pending=args.max_pending or None,
                         tracer=tracer, telemetry=telemetry_cfg)
    logger.info("serving %s (attention_impl=%s, engine %s) on %s:%d, device %s",
                cfg.name, cfg.attention_impl, args.engine, args.host,
                server.server_address[1], generator.device)
    return server


def serve(argv: list[str] | None = None) -> int:
    server = create_server(argv)
    import signal

    def _on_sigterm(signum, frame):
        threading.Thread(target=server.close, daemon=True).start()

    try:
        signal.signal(signal.SIGTERM, _on_sigterm)
    except ValueError:
        pass  # not the main thread
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
    return 0


if __name__ == "__main__":
    import sys

    from ditl_tpu_torch.utils.logging import setup_logging

    setup_logging()
    sys.exit(serve())
