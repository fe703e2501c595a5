"""API eval during training: the port's ``run_api_eval`` and the trainer's
``eval_every`` hook against the JAX package's, over one fake transport and
over a stub ``/chat/completions`` server in-process on 127.0.0.1."""

import collections
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ditl_tpu import config as jconfig  # noqa: E402
from ditl_tpu.client import eval_loop as jeval  # noqa: E402
from ditl_tpu.client import llm as jllm  # noqa: E402
from ditl_tpu.train import trainer as jtrainer  # noqa: E402
from ditl_tpu_torch import config as tconfig  # noqa: E402
from ditl_tpu_torch.client import eval_loop as teval  # noqa: E402
from ditl_tpu_torch.client import llm as tllm  # noqa: E402
from ditl_tpu_torch.data.dataset import synthetic_dataset  # noqa: E402
from ditl_tpu_torch.launch import build_config  # noqa: E402
from ditl_tpu_torch.runtime import distributed as tdist  # noqa: E402
from ditl_tpu_torch.train import trainer as ttrainer  # noqa: E402

torch.set_num_threads(1)

TINY = dict(vocab_size=512, hidden_size=64, intermediate_size=128, num_layers=2,
            num_heads=4, num_kv_heads=2, head_dim=16, max_seq_len=128)


def _mixed_transport(seed: int):
    """Replies drawn from the prompt: positive, negative, unscorable text,
    a 400 (no retry: the sentinel) or a 500 (retried to exhaustion)."""

    def transport(url, headers, body, timeout):
        prompt = json.loads(body)["messages"][-1]["content"]
        kind = int(np.random.default_rng([seed, len(prompt)]).integers(5))
        if kind == 3:
            return 400, {}, b"no"
        if kind == 4:
            return 500, {}, b"down"
        content = ["It is Positive.", "negative", "no idea"][kind]
        return 200, {}, json.dumps({"choices": [{"message": {"content": content}}]}).encode()

    return transport


@pytest.mark.parametrize("seed,max_samples", [(0, 8), (1, 20), (2, 3)])
def test_run_api_eval_matches_jax(seed, max_samples):
    ds = synthetic_dataset(16, seed)
    kw = dict(max_retries=1, backoff_base_s=0.001, backoff_max_s=0.002)
    out = []
    for eval_mod, llm, cfg_mod in ((teval, tllm, tconfig), (jeval, jllm, jconfig)):
        client = llm.LLMClient(cfg_mod.APIConfig(**kw), transport=_mixed_transport(seed))
        out.append(eval_mod.run_api_eval(client, ds.texts, ds.labels,
                                         max_samples=max_samples))
    assert out[0] == out[1]
    assert out[0]["n"] == min(max_samples, 16)


def test_non_coordinator_returns_the_zero_dict(monkeypatch):
    calls = []

    def transport(url, headers, body, timeout):
        calls.append(url)
        return 200, {}, b'{"choices": [{"message": {"content": "positive"}}]}'

    client = tllm.LLMClient(tconfig.APIConfig(), transport=transport)
    assert tdist.is_coordinator()
    monkeypatch.setattr(tdist, "_process_index", lambda: 1)
    assert not tdist.is_coordinator()
    assert teval.run_api_eval(client, ["a"], [1]) == {"n": 0, "n_errors": 0,
                                                       "accuracy": 0.0}
    assert calls == []


def test_eval_every_and_api_overrides_parse():
    items = ["train.eval_every=2", "train.eval_samples=3", "api.api_base=http://h:1/v1",
             "api.total_timeout_s=7.5", "api.max_retries=2", "api.model_name=m",
             "api.max_concurrency=4", "api.api_key_env=K"]
    ours = tconfig.parse_overrides(tconfig.Config(), items)
    ref = jconfig.parse_overrides(jconfig.Config(), items)
    assert ours.api == tconfig.APIConfig(**vars(ref.api))
    assert (ours.train.eval_every, ours.train.eval_samples) == (2, 3)
    config, _ = build_config(["--device", "cpu", *items])
    assert config.api.total_timeout_s == 7.5 and config.train.eval_every == 2
    with pytest.raises(ValueError, match="unknown key"):
        tconfig.parse_overrides(tconfig.Config(), ["api.nonsense=1"])


class _Stub(BaseHTTPRequestHandler):
    log: list = None
    lock: threading.Lock = None

    def do_POST(self):
        payload = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        with self.lock:
            self.log.append((self.path, json.dumps(payload, sort_keys=True)))
        text = payload["messages"][-1]["content"]
        reply = "positive" if len(text) % 2 else "negative"
        body = json.dumps({"choices": [{"message": {"content": reply}}]}).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):
        pass


def _crossings(module, monkeypatch, run) -> list[collections.Counter]:
    """Run ``run(url)`` against a fresh stub with ``module.run_api_eval``
    wrapped; returns each eval call's multiset of (path, body)."""
    log, marks = [], []
    handler = type("Stub", (_Stub,), {"log": log, "lock": threading.Lock()})
    server = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    real = module.run_api_eval

    def recorded(*args, **kw):
        start = len(log)
        out = real(*args, **kw)
        marks.append((start, len(log), out))
        return out

    monkeypatch.setattr(module, "run_api_eval", recorded)
    try:
        run(f"http://127.0.0.1:{server.server_address[1]}/v1")
    finally:
        server.shutdown()
        server.server_close()
    assert len(log) == marks[-1][1]
    return [(collections.Counter(log[a:b]), out) for a, b, out in marks]


def test_trainer_sends_the_reference_requests_at_each_crossing(monkeypatch):
    """``train()`` with ``train.eval_every=2`` over 5 steps: at steps 2 and 4
    the stub receives ``eval_samples`` chat requests, the same multiset of
    bodies the JAX trainer sends at the same config, and both score them
    alike."""
    data = dict(synthetic=True, synthetic_examples=24, batch_size=8, seq_len=64, seed=3)
    train = dict(total_steps=5, eval_every=2, eval_samples=5, log_every=1,
                 warmup_steps=1)

    def api(url):
        return dict(api_base=url, timeout_s=30.0, max_retries=0, model_name="stub-model")

    def ours(url):
        config = tconfig.Config(model=tconfig.ModelConfig(**TINY, dtype="float32"),
                                data=tconfig.DataConfig(**data),
                                train=tconfig.TrainConfig(**train),
                                api=tconfig.APIConfig(**api(url)))
        assert ttrainer.train(config, device="cpu")["steps"] == 5

    def ref(url):
        config = jconfig.Config(model=jconfig.ModelConfig(**TINY, dtype="float32",
                                                          param_dtype="float32"),
                                data=jconfig.DataConfig(**data),
                                train=jconfig.TrainConfig(**train),
                                api=jconfig.APIConfig(**api(url)))
        jtrainer.train(config)

    got = _crossings(ttrainer, monkeypatch, ours)
    want = _crossings(jtrainer, monkeypatch, ref)
    assert len(got) == len(want) == 2
    assert got == want
    for bodies, out in got:
        assert sum(bodies.values()) == 5 and out["n"] == 5 and out["n_errors"] == 0
        assert {path for path, _ in bodies} == {"/v1/chat/completions"}
