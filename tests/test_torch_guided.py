"""Port parity: grammar-constrained decoding on the continuous engine, in
the scenarios of ``tests/test_guided.py``.

The JAX ``ContinuousEngine`` (``cache_mode="paged"``, ``fsm_capacity > 0``)
and the port's run the same requests on the same weights (the reference
tests' tiny f32 config, page size 16, 16-token budgets): greedy guided tokens
must be identical on plain ticks, in a mixed batch where unconstrained rows
share the ticks, under JSON schemas and JSON mode, over chunked prefill, on
prompt-lookup and draft-model speculative ticks, over int8 pools, and with a
guided request preempted and resumed under optimistic admission. Logprobs
of guided requests agree within ``LP_TOL``; registration bookkeeping (start
states, dedupe, ``stats()["guided"]``, the error messages) is the
reference's. The JAX engines run once, by a module fixture, sharing one
engine wherever the configuration allows. Port-only checks: unconstrained
rows on a guided engine are bit-identical to a guided-off engine's, sampled
guided outputs fullmatch (or are a live prefix at the budget) and repeat
per seed, and speculative guided ticks give the plain guided tokens.
"""

import dataclasses
import json
import re

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ditl_tpu.config import ModelConfig as JaxModelConfig  # noqa: E402
from ditl_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer  # noqa: E402
from ditl_tpu.infer import grammar as JG  # noqa: E402
from ditl_tpu.infer.continuous import ContinuousEngine as JaxEngine  # noqa: E402
from ditl_tpu.infer.engine import GenerateConfig as JaxGenerateConfig  # noqa: E402
from ditl_tpu.models import llama as jllama  # noqa: E402
from ditl_tpu_torch.config import ModelConfig  # noqa: E402
from ditl_tpu_torch.data.tokenizer import ByteTokenizer  # noqa: E402
from ditl_tpu_torch.infer import grammar as G  # noqa: E402
from ditl_tpu_torch.infer.continuous import BadRequestError, ContinuousEngine  # noqa: E402
from ditl_tpu_torch.infer.engine import GenerateConfig  # noqa: E402
from ditl_tpu_torch.models.convert import params_from_jax  # noqa: E402

torch.set_num_threads(1)

TINY = dict(vocab_size=512, hidden_size=64, intermediate_size=128, num_layers=2,
            num_heads=4, num_kv_heads=2, head_dim=16, max_seq_len=128, dtype="float32")
LP_TOL = 1e-5  # guided logprobs against the JAX engine's (f32 on both sides)

GRAMMARS = {
    "phone": ("regex", r"[0-9]{3}-[0-9]{4}"),
    "yesno": ("regex", r"(yes|no)"),
    "year": ("regex", r"[0-9]{4}"),
    "words": ("regex", r"[a-z ]{1,30}"),
    "int": ("regex", r"-?[0-9]{1,6}"),
    "foobar": ("regex", r"(foo|bar){1,4}"),
    "long": ("regex", r"[a-z ]{40,90}"),
    "ab": ("regex", r"[ab]{2,6}"),
    "json3": ("json", 3),
    "color": ("schema", {"enum": ["red", "green", "blue"]}),
    "record": ("schema", {"type": "object", "properties": {
        "n": {"type": "integer", "minimum": 0, "maximum": 99},
        "u": {"anyOf": [{"const": "a"}, {"const": "b"}]}},
        "required": ["n", "u"], "additionalProperties": False}),
}

# Engine kinds: (settings, max_new). "base" serves several scenarios: its
# prefill_chunk only chunks prompts longer than 16 tokens, its logprobs_k
# changes no token.
ENGINES = {
    "base": (dict(fsm_capacity=4096, logprobs_k=3, prefill_chunk=16), 16),
    "spec": (dict(fsm_capacity=4096, speculative=True, spec_k=4, spec_threshold=0.0), 16),
    # the target as its own drafter: its greedy drafts ignore the grammar, so
    # rounds accept legal drafts and reject illegal ones at their positions
    "draft": (dict(fsm_capacity=4096, speculative=True, spec_k=4, spec_rounds=2,
                   draft=True), 16),
    "int8": (dict(fsm_capacity=4096, kv8=True), 16),
    # 9 usable pages: two 17-token prompts with 96-token budgets cannot both
    # run to their ends, so the younger is preempted and resumed
    "preempt": (dict(fsm_capacity=4096, admission="optimistic", n_pages=10), 96),
}
SPAN = ["the cat sat on the the cat sat on the", "a b a b a b a b", "n = 1 2 3 1 2 3",
        "abc abc abc"]
# Scenario -> (engine kind, [(prompt, grammar name or None, submit kwargs)]).
SCENARIOS = {
    "plain": ("base", [("call me at", "phone", {}), ("the number is", "phone", {})]),
    "mixed": ("base", [("answer:", "yesno", {}), ("tell me", None, {}),
                       ("hello world", None, {}), ("pick", "color", {})]),
    "json": ("base", [("emit json", "json3", {}), ("extract", "record", {}),
                      ("pick a color", "color", {})]),
    "chunked": ("base", [("word " * 12, "foobar", {}), ("a longer prompt " * 4, "json3", {}),
                         ("hi", "phone", {})]),
    "logprobs": ("base", [("year:", "year", {"logprobs": 2}), ("tell me", None, {"logprobs": 3}),
                          ("emit json", "json3", {"logprobs": 3})]),
    "spec": ("spec", [(SPAN[0], "words", {}), (SPAN[1], "words", {}), (SPAN[2], "int", {}),
                      (SPAN[3], None, {})]),
    "draft": ("draft", [(SPAN[0], "words", {}), (SPAN[1], "words", {}), (SPAN[2], "int", {}),
                        (SPAN[3], None, {})]),
    "int8": ("int8", [("call me at", "phone", {}), ("emit json", "json3", {}),
                      ("tell me", None, {})]),
    "preempt": ("preempt", [("alpha beta gamma", "long", {}), ("delta epsilon zeta", "long", {})]),
}


@pytest.fixture(scope="module")
def models():
    """(JAX cfg, JAX params, port cfg, port params), the port's weights
    converted from the JAX package's."""
    jcfg, cfg = JaxModelConfig(**TINY, param_dtype="float32"), ModelConfig(**TINY)
    params = jllama.init_params(jax.random.key(0), jcfg)
    return jcfg, params, cfg, params_from_jax(jax.device_get(params), cfg, "cpu")


_COMPILED: dict = {}


def _grammar(mod, tok, name: str):
    """Grammar ``name`` compiled by ``mod`` (the port's or the reference's
    ``infer/grammar``), once."""
    key = (mod.__name__, name)
    if key not in _COMPILED:
        kind, spec = GRAMMARS[name]
        _COMPILED[key] = (mod.compile_regex(spec, tok) if kind == "regex"
                          else mod.compile_json(tok, max_depth=spec) if kind == "json"
                          else mod.compile_json_schema(spec, tok))
    return _COMPILED[key]


def _make(models, kind: str, port: bool, **over):
    """The port's (``port``) or the JAX package's engine of ``kind``."""
    jcfg, jparams, cfg, tparams = models
    kw, max_new = ENGINES[kind]
    kw = {**kw, **over}
    kw.setdefault("n_slots", 4)
    kw.setdefault("decode_chunk", 4)
    if kw.pop("kv8", False):
        jcfg = dataclasses.replace(jcfg, kv_cache_dtype="int8")
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    if kw.pop("draft", False):
        kw.update(draft_params=tparams if port else jparams, draft_cfg=cfg if port else jcfg)
    if port:
        return ContinuousEngine(tparams, cfg, ByteTokenizer(), cache_mode="paged", page_size=16,
                                gen=GenerateConfig(max_new_tokens=max_new), device="cpu", **kw)
    return JaxEngine(jparams, jcfg, JaxByteTokenizer(), cache_mode="paged", page_size=16,
                     gen=JaxGenerateConfig(max_new_tokens=max_new), **kw)


def _run(eng, requests, **submit_kw) -> list:
    """Submit ``requests`` together and step to the end: the finished
    requests in submission order."""
    tok = eng.tokenizer
    mod = G if isinstance(eng, ContinuousEngine) else JG
    rids = []
    for prompt, name, kw in requests:
        g = None if name is None else _grammar(mod, tok, name)
        rids.append(eng.submit([tok.bos_id] + tok.encode(prompt), grammar=g,
                               **{"temperature": 0.0, **kw, **submit_kw}))
    done, steps = {}, 0
    while eng.pending:
        eng.step()
        steps += 1
        assert steps < 2000
        done.update({r.req_id: r for r in eng.take_finished()})
    return [done[r] for r in rids]


@pytest.fixture(scope="module")
def runs(models):
    """Every scenario on both packages: {scenario: (JAX requests, port
    requests)}, plus the engines' guided stats."""
    out, engines = {}, {}
    for name, (kind, requests) in SCENARIOS.items():
        pair = []
        for port in (False, True):
            key = (kind, port)
            if key not in engines:
                engines[key] = _make(models, kind, port)
            pair.append(_run(engines[key], requests))
        out[name] = tuple(pair)
    out["stats"] = {key: eng.stats() for key, eng in engines.items()}
    return out


def _text(tok, req) -> str:
    return tok.decode(req.tokens)


def _walks(g, text: str, finished_at_eos: bool) -> bool:
    """Every byte of ``text`` is a live transition of ``g``'s byte DFA, and
    a request that ended at EOS fullmatches."""
    s = 0
    for b in text.encode():
        s = int(g.byte_next[s, b])
        if s < 0:
            return False
    return bool(g.accept[s]) or not finished_at_eos


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_greedy_guided_tokens_match_jax(runs, scenario):
    jreqs, treqs = runs[scenario]
    assert [r.tokens for r in treqs] == [r.tokens for r in jreqs]
    tok = ByteTokenizer()
    _, requests = SCENARIOS[scenario]
    max_new = ENGINES[SCENARIOS[scenario][0]][1]
    for (prompt, name, _), req in zip(requests, treqs):
        if name is None:
            continue
        g = _grammar(G, tok, name)
        assert _walks(g, _text(tok, req), len(req.tokens) < max_new), (name, _text(tok, req))


def test_guided_outputs_conform(runs):
    """The reference's own checks on the port's outputs: bounded regexes end
    at EOS with a full match, the enum schema parses to a member, the record
    schema to its fields."""
    tok = ByteTokenizer()
    plain = [_text(tok, r) for r in runs["plain"][1]]
    assert all(re.fullmatch(r"[0-9]{3}-[0-9]{4}", t) for t in plain), plain
    mixed = runs["mixed"][1]
    assert _text(tok, mixed[0]) in ("yes", "no")
    assert json.loads(_text(tok, mixed[3])) in ("red", "green", "blue")
    assert json.loads(_text(tok, runs["json"][1][2])) in ("red", "green", "blue")
    rec = runs["json"][1][1]
    if len(rec.tokens) < 16:
        doc = json.loads(_text(tok, rec))
        assert set(doc) == {"n", "u"} and 0 <= doc["n"] <= 99 and doc["u"] in ("a", "b")
    assert re.fullmatch(r"(foo|bar){1,4}", _text(tok, runs["chunked"][1][0]))


def test_chunked_and_preempted_requests_took_those_paths(runs, models):
    """The chunked scenario's long prompts were prefilled in chunks on both
    engines (several prefill forwards), and the preemption scenario preempted
    and resumed a guided request on both, the same number of times."""
    jreqs, treqs = runs["preempt"]
    assert [r.preempt_count for r in treqs] == [r.preempt_count for r in jreqs]
    assert sum(r.preempt_count for r in treqs) >= 1
    st = runs["stats"][("preempt", True)]
    assert st["preemptions"] >= 1 and st["resume_prefill_tokens"] > 0
    # The port's chunk counter: a 61-token prompt in chunks of 16 is 4 prefills.
    eng = _make(models, "base", True)
    calls = []
    inner = eng._paged_prefill_chunk

    def spy(req, slot, d, s, generator, **kw):
        calls.append((d, s))
        return inner(req, slot, d, s, generator, **kw)

    eng._paged_prefill_chunk = spy
    got = _run(eng, SCENARIOS["chunked"][1][:1])
    assert calls == [(0, 16), (16, 16), (32, 16), (48, 13)]
    assert got[0].tokens == runs["chunked"][1][0].tokens


def test_preempted_guided_request_resumes_to_its_uncontended_tokens(runs, models):
    """The preempted guided requests give the tokens they give alone on a
    pool that never preempts (the slot's grammar state restored)."""
    alone = _run(_make(models, "preempt", True, admission="reserve", n_pages=None),
                 SCENARIOS["preempt"][1])
    assert [r.tokens for r in runs["preempt"][1]] == [r.tokens for r in alone]
    assert all(r.preempt_count == 0 for r in alone)


def test_guided_logprobs_match_jax(runs):
    """Chosen-token logprobs and the top alternatives of guided requests (and
    an unconstrained one beside them) against the JAX engine's: raw logits,
    within ``LP_TOL``; the top ids exactly."""
    jreqs, treqs = runs["logprobs"]
    for j, t in zip(jreqs, treqs):
        n = len(t.tokens)
        assert n and len(t.lp_token) >= n
        assert t.lp_token[:n] == pytest.approx(j.lp_token[:n], abs=LP_TOL)
        assert t.lp_top_ids[:n] == j.lp_top_ids[:n]
        for a, b in zip(t.lp_top[:n], j.lp_top[:n]):
            assert a == pytest.approx(b, abs=LP_TOL)
    assert re.fullmatch(r"[0-9]{4}", ByteTokenizer().decode(treqs[0].tokens))


@pytest.mark.parametrize("scenario", ["spec", "draft"])
def test_speculative_guided_ticks_give_the_plain_guided_tokens(runs, models, scenario):
    """Greedy speculative ticks under a grammar (prompt lookup, a draft
    model) emit the plain guided ticks' tokens; every guided output is
    drawn from its grammar."""
    plain = _run(_make(models, "base", True), SCENARIOS[scenario][1])
    spec = runs[scenario][1]
    assert [r.tokens for r in spec] == [r.tokens for r in plain]
    st = runs["stats"][(scenario, True)]
    assert st["speculative"]["spec_ticks"] >= 1


def test_unconstrained_rows_are_bit_identical_to_a_guided_off_engine(models):
    """Unconstrained rows, greedy and sampled, alone and sharing ticks with
    guided rows, give exactly the tokens of an engine built without
    ``fsm_capacity``."""
    free = [("tell me", None, {}), ("hello world", None, {"temperature": 0.9, "seed": 5}),
            ("abc abc abc", None, {})]
    off = _run(_make(models, "base", True, fsm_capacity=0), free)
    guided_alone = _run(_make(models, "base", True), free)
    mixed = _run(_make(models, "base", True),
                 free + [("answer:", "yesno", {}), ("emit json", "json3", {"temperature": 0.7,
                                                                          "seed": 3})])
    want = [r.tokens for r in off]
    assert [r.tokens for r in guided_alone] == want
    assert [r.tokens for r in mixed[:3]] == want


@pytest.mark.parametrize("kind", ["base", "spec"])
def test_sampled_guided_outputs_conform_and_repeat_per_seed(models, kind):
    """Sampled guided requests (plain ticks, and the speculative ticks'
    rejection sampling) fullmatch, or are a live prefix at the budget, and
    the same seed gives the same tokens."""
    requests = [("x", "ab", {"temperature": 0.9, "seed": 7}),
                ("emit json", "json3", {"temperature": 1.0, "seed": 11, "top_p": 0.9}),
                ("the cat", "words", {"temperature": 0.8, "seed": 2})]
    tok = ByteTokenizer()
    first = _run(_make(models, kind, True), requests)
    again = _run(_make(models, kind, True), requests)
    assert [r.tokens for r in first] == [r.tokens for r in again]
    for (_, name, _), req in zip(requests, first):
        g = _grammar(G, tok, name)
        assert _walks(g, _text(tok, req), len(req.tokens) < 16), (name, _text(tok, req))
    assert re.fullmatch(r"[ab]{2,6}", _text(tok, first[0]))


def test_guided_stats_match_jax(runs):
    """``stats()["guided"]`` after the same registrations: rows used and
    grammars registered (the shared engine's dedupe across scenarios)."""
    for kind in ENGINES:
        assert (runs["stats"][(kind, True)]["guided"]
                == runs["stats"][(kind, False)]["guided"]), kind


def _messages(make, tok, mod):
    """Registration bookkeeping on a 64-row table, and every refusal's type
    and message."""
    out = []
    eng = make(fsm_capacity=64)
    g1 = mod.compile_regex(r"[ab]+", tok)
    b1 = eng.register_grammar(g1)
    out.append(("start", b1, eng.register_grammar(g1)))
    b2 = eng.register_grammar(mod.compile_regex(r"[cd]+", tok))
    out.append(("second", b2, eng.stats()["guided"]))

    def refused(fn):
        try:
            fn()
        except Exception as e:  # noqa: BLE001 - the type and text are compared
            return (isinstance(e, ValueError), type(e).__name__, str(e))
        return None

    big = mod.compile_json(tok, max_depth=3)
    out.append(("exhausted", refused(lambda: eng.register_grammar(big))))
    out.append(("bad start", refused(lambda: eng.submit([3], grammar=eng._fsm_used))))
    out.append(("negative start", refused(lambda: eng.submit([3], grammar=-1))))
    wide = mod.CompiledGrammar(token_next=np.full((2, 600), -1, np.int32),
                               accept=g1.accept[:2], source="wide")
    out.append(("vocab", refused(lambda: eng.register_grammar(wide))))
    out.append(("off", refused(lambda: make(fsm_capacity=0).submit([3], grammar=g1))))
    out.append(("off register", refused(lambda: make(fsm_capacity=0).register_grammar(g1))))
    out.append(("capacity 1", refused(lambda: make(fsm_capacity=1))))
    out.append(("capacity -1", refused(lambda: make(fsm_capacity=-1))))
    # an int start state rides to the end: the output is drawn from [ab]+
    rid = eng.submit([tok.bos_id] + tok.encode("q"), grammar=b1)
    text = tok.decode(eng.run()[rid])
    out.append(("int start", bool(re.fullmatch(r"[ab]+", text) or text == "")))
    out.append(("final", eng.stats()["guided"]))
    return out


def test_registration_bookkeeping_and_refusals_match_jax(models):
    ours = _messages(lambda **kw: _make(models, "base", True, **kw), ByteTokenizer(), G)
    ref = _messages(lambda **kw: _make(models, "base", False, **kw), JaxByteTokenizer(), JG)
    assert ours == ref
    assert ours[0] == ("start", 2, 2)
    assert ours[2][1][2].startswith("fsm_capacity exhausted: ")
    # the submit refusals are the client's fault: BadRequestError in the port
    for row in ours[3:5] + ours[6:7]:
        assert row[1][1] == BadRequestError.__name__, row
