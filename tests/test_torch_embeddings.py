"""``/v1/embeddings`` on the port's server against the JAX package's server
at tiny f32 weights converted from the JAX package's, the LLM client's
``embed`` against the port's own server, and ``ops/encode.py`` against the
JAX package's. Every server is in-process on 127.0.0.1."""

import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ditl_tpu.config import ModelConfig as JaxModelConfig  # noqa: E402
from ditl_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer  # noqa: E402
from ditl_tpu.infer import server as jserver  # noqa: E402
from ditl_tpu.infer.engine import Generator as JaxGenerator  # noqa: E402
from ditl_tpu.models import llama as jllama  # noqa: E402
from ditl_tpu.ops import encode as jencode  # noqa: E402
from ditl_tpu_torch.client import LLMClient  # noqa: E402
from ditl_tpu_torch.config import APIConfig, ModelConfig  # noqa: E402
from ditl_tpu_torch.data.tokenizer import ByteTokenizer  # noqa: E402
from ditl_tpu_torch.infer import server as tserver  # noqa: E402
from ditl_tpu_torch.infer.continuous import ContinuousEngine, ThreadedEngine  # noqa: E402
from ditl_tpu_torch.infer.engine import Generator  # noqa: E402
from ditl_tpu_torch.models.convert import params_from_jax  # noqa: E402
from ditl_tpu_torch.ops import encode as tencode  # noqa: E402

torch.set_num_threads(1)

TINY = dict(vocab_size=512, hidden_size=64, intermediate_size=128, num_layers=2,
            num_heads=4, num_kv_heads=2, head_dim=16, max_seq_len=128, dtype="float32")


def _start(srv):
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    return f"http://127.0.0.1:{srv.server_address[1]}", thread


@pytest.fixture(scope="module")
def servers():
    """The port's lock-step and continuous servers and the JAX package's
    lock-step server over the same weights."""
    jcfg, cfg = JaxModelConfig(**TINY, param_dtype="float32"), ModelConfig(**TINY)
    params = jllama.init_params(jax.random.key(0), jcfg)
    tparams = params_from_jax(jax.device_get(params), cfg, "cpu")
    built = {
        "lockstep": tserver.make_server(Generator(tparams, cfg, ByteTokenizer(),
                                                  device="cpu"), port=0, model_name="tiny"),
        "continuous": tserver.make_server(
            Generator(tparams, cfg, ByteTokenizer(), device="cpu"), port=0,
            threaded_engine=ThreadedEngine(ContinuousEngine(
                tparams, cfg, ByteTokenizer(), device="cpu", n_slots=2,
                cache_mode="paged", page_size=16))),
        "jax": jserver.make_server(JaxGenerator(params, jcfg, JaxByteTokenizer()), port=0),
    }
    running = {name: (_start(srv), srv) for name, srv in built.items()}
    try:
        yield {name: url for name, ((url, _), _) in running.items()}
    finally:
        for (_, thread), srv in running.values():
            srv.close(drain=False)
            thread.join(timeout=30)


def _post(url: str, payload):
    req = urllib.request.Request(url + "/v1/embeddings", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


_RNG = np.random.default_rng(0)
FORMS = {
    "string": "hello embeddings",
    "strings": ["a", "a much longer input " * 3, "héllo ✓"],
    "token array": [int(x) for x in _RNG.integers(3, 259, 40)],
    "token arrays": [[1, 72, 105], [], [int(x) for x in _RNG.integers(0, 512, 70)]],
    "mixed": ["text", [1, 50, 60, 70], "more text"],
    "past max_seq_len": ["x" * 300, "short"],
}


@pytest.mark.parametrize("engine", ["lockstep", "continuous"])
@pytest.mark.parametrize("form", list(FORMS))
def test_embeddings_match_the_reference(servers, engine, form):
    """Every input form: the port's vectors within 1e-5 of the JAX
    server's, unit length, in input order, with the same usage (truncation
    at max_seq_len included)."""
    payload = {"input": FORMS[form], "model": "m"}
    status, ours = _post(servers[engine], payload)
    jstatus, ref = _post(servers["jax"], payload)
    assert status == jstatus == 200
    assert ours["object"] == "list" and ours["model"] == "m"
    assert ours["usage"] == ref["usage"]
    assert [d["index"] for d in ours["data"]] == [d["index"] for d in ref["data"]]
    got = np.array([d["embedding"] for d in ours["data"]])
    want = np.array([d["embedding"] for d in ref["data"]])
    assert got.shape == want.shape and got.shape[1] == TINY["hidden_size"]
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


def test_truncation_and_usage(servers):
    url = servers["lockstep"]
    tok = ByteTokenizer()
    long = "y" * 500
    status, body = _post(url, {"input": [long, "ab"]})
    assert status == 200
    assert body["usage"] == {"prompt_tokens": 128 + 3, "total_tokens": 128 + 3}
    ids = ([tok.bos_id] + tok.encode(long))[:128]
    status, same = _post(url, {"input": ids})
    assert status == 200
    np.testing.assert_allclose(body["data"][0]["embedding"], same["data"][0]["embedding"],
                               atol=1e-6)


BAD = [{"input": None}, {"input": 3}, {"input": []}, {"input": ["x"] * 65},
       {"input": [{"a": 1}]}, {"input": ["ok", [1.5, 2]]}, {}]


@pytest.mark.parametrize("payload", BAD, ids=[str(i) for i in range(len(BAD))])
def test_bad_inputs_answer_400_as_the_reference(servers, payload):
    status, body = _post(servers["lockstep"], payload)
    jstatus, jbody = _post(servers["jax"], payload)
    assert status == jstatus == 400
    assert body["error"]["message"] == jbody["error"]["message"]


def test_out_of_table_token_ids_answer_400(servers):
    """An id past the embedding table would be an out-of-bounds read on the
    card; the port refuses it."""
    for ids in ([1, 512], [-1, 5]):
        status, body = _post(servers["lockstep"], {"input": ids})
        assert status == 400 and "token ids" in body["error"]["message"]


def test_client_embed_against_the_ports_own_server(servers):
    for name in ("lockstep", "continuous"):
        client = LLMClient(APIConfig(api_base=servers[name] + "/v1", timeout_s=60.0))
        vecs = client.embed(["hello", "world"])
        assert vecs is not None and len(vecs) == 2
        assert len(vecs[0]) == TINY["hidden_size"]
        assert client.embed("hello")[0] == vecs[0]


TEXTS = ["", "plain ascii", "héllo wörld ✓", "😀 emoji " * 5, "x" * 2000]


@pytest.mark.parametrize("max_len", [16, 1024])
def test_encode_matches_the_reference(max_len):
    for ours, ref in zip(tencode.encode_texts(TEXTS, max_len),
                         jencode.encode_texts(TEXTS, max_len)):
        np.testing.assert_array_equal(ours, ref)
    got = tencode.encode_and_reduce(TEXTS, max_len, device="cpu")
    want = jencode.encode_and_reduce(TEXTS, max_len)
    assert got.shape == want.shape == (len(TEXTS),) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_encode_default_device_is_the_card():
    if torch.cuda.is_available():
        got = tencode.encode_and_reduce(TEXTS)
        np.testing.assert_allclose(got, tencode.encode_and_reduce(TEXTS, device="cpu"),
                                   rtol=1e-6)
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tencode.encode_and_reduce(TEXTS)
