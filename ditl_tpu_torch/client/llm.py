"""Remote-LLM client: OpenAI-compatible chat completions and embeddings.
A copy of the JAX package's ``client/llm.py`` (stdlib only).

``get_model_response(prompt)`` is a **total function**: it never raises;
any failure returns ``ERROR_SENTINEL``. Beyond that contract:

- exponential backoff with jitter on 429/5xx/connection errors, honoring
  ``Retry-After``, bounded by ``max_retries`` and by the whole call's
  ``total_timeout_s`` deadline;
- a bounded-concurrency batch path (``complete_many``), so API eval does
  not send its examples one after another;
- an injectable transport (the test seam), and the fault plane's
  ``client.request`` seam (``chaos/plane.py``) before each attempt.

Built on stdlib ``urllib`` against the ``/chat/completions`` and
``/embeddings`` wire format every OpenAI-compatible server speaks (the
port's own server among them, ``infer/server.py``).
"""

from __future__ import annotations

import json
import random
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Sequence

from ditl_tpu_torch.chaos import maybe_inject
from ditl_tpu_torch.config import APIConfig
from ditl_tpu_torch.telemetry.registry import MetricsRegistry
from ditl_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

ERROR_SENTINEL = "Error: Unable to get model response"

__all__ = ["ERROR_SENTINEL", "ClientMetrics", "LLMClient",
           "client_metrics", "get_model_response"]

Transport = Callable[[str, dict, bytes, float], tuple[int, dict, bytes]]


class ClientMetrics:
    """Remote-LLM client telemetry (telemetry/registry.py instruments):
    how often the retry machinery engages and how it ends. Module-level
    singleton (``client_metrics``) shared by every LLMClient in the
    process — the eval loop constructs clients per call, and per-instance
    registries would scatter the counts."""

    def __init__(self, registry: MetricsRegistry | None = None):
        self.registry = registry if registry is not None else MetricsRegistry()
        r = self.registry
        self.requests = r.counter(
            "ditl_client_requests", "remote-LLM logical calls started")
        self.retries = r.counter(
            "ditl_client_retries", "HTTP attempts retried (429/5xx/conn)")
        self.retry_exhausted = r.counter(
            "ditl_client_retry_exhausted",
            "calls that failed after exhausting max_retries")
        self.deadline_exhausted = r.counter(
            "ditl_client_deadline_exhausted",
            "calls aborted by the total_timeout_s wall-clock bound")


client_metrics = ClientMetrics()


class HTTPStatusError(Exception):
    def __init__(self, status: int, headers: dict, body: bytes):
        super().__init__(f"HTTP {status}")
        self.status = status
        self.headers = headers
        self.body = body


def _urllib_transport(url: str, headers: dict, body: bytes, timeout: float):
    req = urllib.request.Request(url, data=body, headers=headers, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers or {}), e.read()


class LLMClient:
    def __init__(self, config: APIConfig | None = None, transport: Transport | None = None):
        self.config = config or APIConfig()
        self.transport = transport or _urllib_transport

    # -- low level ----------------------------------------------------------

    def _request_once(self, payload: dict, endpoint: str = "/chat/completions",
                      timeout_s: float | None = None) -> dict:
        cfg = self.config
        # Chaos seam: `error` becomes an OSError — a transport-level
        # failure that exercises the REAL retry/backoff/deadline path
        # (an InjectedFault would bypass the retryable-exception filter).
        fault = maybe_inject("client.request", handles=("error",))
        if fault is not None and fault.action == "error":
            raise OSError("chaos: injected client transport failure")
        url = cfg.api_base.rstrip("/") + endpoint
        headers = {
            "Content-Type": "application/json",
            "Authorization": f"Bearer {cfg.api_key()}",
        }
        body = json.dumps(payload).encode("utf-8")
        status, resp_headers, resp_body = self.transport(
            url, headers, body,
            cfg.timeout_s if timeout_s is None else timeout_s,
        )
        if status != 200:
            raise HTTPStatusError(status, resp_headers, resp_body)
        return json.loads(resp_body)

    def _request_with_retries(self, payload: dict, endpoint: str = "/chat/completions") -> dict:
        """Retry loop with exponential backoff, bounded two ways: attempt
        count (``max_retries``) and total wall
        clock (``total_timeout_s``): per-attempt timeouts are clamped to
        the remaining budget and backoff never sleeps past the deadline,
        so one dead endpoint can no longer stall a caller for
        ``max_retries x (timeout_s + backoff_max_s)``."""
        cfg = self.config
        deadline = (
            time.monotonic() + cfg.total_timeout_s
            if cfg.total_timeout_s > 0 else None
        )
        client_metrics.requests.inc()
        last_exc: Exception | None = None

        def _remaining() -> float | None:
            return None if deadline is None else deadline - time.monotonic()

        for attempt in range(cfg.max_retries + 1):
            timeout_s = cfg.timeout_s
            remaining = _remaining()
            if remaining is not None:
                if remaining <= 0:
                    client_metrics.deadline_exhausted.inc()
                    raise TimeoutError(
                        f"total_timeout_s={cfg.total_timeout_s}s exhausted "
                        f"after {attempt} attempt(s)"
                    ) from last_exc
                timeout_s = min(timeout_s, remaining)
            try:
                return self._request_once(payload, endpoint, timeout_s)
            except HTTPStatusError as e:
                last_exc = e
                retryable = e.status == 429 or e.status >= 500
                if not retryable or attempt == cfg.max_retries:
                    if retryable:
                        client_metrics.retry_exhausted.inc()
                    raise
                delay = self._backoff_delay(attempt, e.headers)
            except (urllib.error.URLError, OSError, TimeoutError) as e:
                last_exc = e
                if attempt == cfg.max_retries:
                    client_metrics.retry_exhausted.inc()
                    raise
                delay = self._backoff_delay(attempt, {})
            remaining = _remaining()
            if remaining is not None and delay >= remaining:
                # The backoff alone would overshoot the deadline: stop now
                # rather than sleep into a guaranteed failure.
                client_metrics.deadline_exhausted.inc()
                raise TimeoutError(
                    f"total_timeout_s={cfg.total_timeout_s}s exhausted "
                    f"after {attempt + 1} attempt(s) (backoff {delay:.2f}s "
                    "would overshoot)"
                ) from last_exc
            client_metrics.retries.inc()
            logger.warning(
                "API request failed (%s), retry %d/%d in %.2fs",
                last_exc,
                attempt + 1,
                cfg.max_retries,
                delay,
            )
            time.sleep(delay)
        raise last_exc  # unreachable

    def _backoff_delay(self, attempt: int, headers: dict) -> float:
        retry_after = headers.get("Retry-After") or headers.get("retry-after")
        if retry_after:
            try:
                return min(float(retry_after), self.config.backoff_max_s)
            except ValueError:
                pass
        base = self.config.backoff_base_s * (2**attempt)
        return min(base, self.config.backoff_max_s) * (0.5 + random.random() / 2)

    # -- public surface -----------------------------------------------------

    def complete(self, prompt: str, system: str | None = None) -> str:
        """Single-turn completion. Total function: returns ``ERROR_SENTINEL``
        on any failure."""
        messages = []
        if system:
            messages.append({"role": "system", "content": system})
        messages.append({"role": "user", "content": prompt})
        payload = {"model": self.config.model_name, "messages": messages}
        try:
            response = self._request_with_retries(payload)
            return response["choices"][0]["message"]["content"]
        except Exception as e:
            logger.error("Error getting model response: %s", e)
            return ERROR_SENTINEL

    def embed(self, texts: str | Sequence[str]) -> list[list[float]] | None:
        """Embeddings from the endpoint's ``/embeddings`` route (this
        framework's own server serves it; any OpenAI-compatible endpoint
        works). Total function like ``complete``: ``None`` on any failure,
        never raises."""
        payload = {
            "model": self.config.model_name,
            "input": texts if isinstance(texts, str) else list(texts),
        }
        try:
            resp = self._request_with_retries(payload, endpoint="/embeddings")
            data = sorted(resp["data"], key=lambda d: d["index"])
            return [d["embedding"] for d in data]
        except Exception as e:
            logger.error("Error getting embeddings: %s", e)
            return None

    def complete_many(self, prompts: Sequence[str], system: str | None = None) -> list[str]:
        """Bounded-concurrency fan-out; order-preserving; each element total."""
        if not prompts:
            return []
        workers = max(1, min(self.config.max_concurrency, len(prompts)))
        with ThreadPoolExecutor(max_workers=workers) as pool:
            return list(pool.map(lambda p: self.complete(p, system), prompts))


def get_model_response(prompt: str, config: APIConfig | None = None) -> str:
    """Module-level ``get_model_response(prompt) -> str``: one ``complete``
    through a fresh client."""
    return LLMClient(config).complete(prompt)
