"""Port parity of the continuous engine's telemetry on pages
(``cache_mode="paged"``, page size 16): the schedules, checks and helpers of
``tests/test_torch_serving_telemetry.py``, plus optimistic admission's
preemption and exact resume, and the paged register_prefix (a warm of the
page cache) whose pages later prompts match."""

import pytest

torch = pytest.importorskip("torch")

from test_torch_serving_telemetry import (  # noqa: E402
    PROMPTS,
    Results,
    _cancel,
    _chunked,
    _deadline,
    _drain,
    _ids,
    _lookup,
    _more_than_slots,
    _plain,
    _queue_full,
    check_schedule,
    models,  # noqa: F401 (the module fixture)
)

torch.set_num_threads(1)

PAGED = dict(cache_mode="paged", page_size=16)


def _preempt(eng, full):
    # 4 usable pages, each request booking 2 at admission and needing 3 by
    # its end: the younger is preempted, then resumes exactly
    eng.submit([1] + list(range(5, 21)), max_new_tokens=16)
    eng.submit([1] + list(range(30, 46)), max_new_tokens=16)
    return _drain(eng)


def _paged_prefix(eng, full):
    prefix = _ids("you are a helpful assistant. " * 2)  # 3 full pages
    eng.register_prefix(prefix)
    eng.submit(prefix + list(b" say hi"))
    eng.submit(_ids("cold prompt"))
    return _drain(eng)


SCHEDULES = {
    "plain": (dict(n_slots=2, decode_chunk=4, **PAGED), _plain),
    "more_than_slots": (dict(n_slots=2, decode_chunk=4, **PAGED), _more_than_slots),
    "chunked": (dict(n_slots=2, decode_chunk=4, prefill_chunk=32, token_budget=48, **PAGED),
                _chunked),
    "lookup": (dict(n_slots=2, decode_chunk=4, speculative=True, spec_k=4,
                    spec_threshold=0.0, **PAGED), _lookup),
    "preempt": (dict(n_slots=2, decode_chunk=4, n_pages=5, admission="optimistic", **PAGED),
                _preempt),
    "deadline": (dict(n_slots=2, decode_chunk=4, **PAGED), _deadline),
    "cancel": (dict(n_slots=2, decode_chunk=4, **PAGED), _cancel),
    "queue_full": (dict(n_slots=1, decode_chunk=4, max_queue=1, **PAGED), _queue_full),
    "prefix": (dict(n_slots=2, decode_chunk=4, **PAGED), _paged_prefix),
}


@pytest.fixture(scope="module")
def results(models, tmp_path_factory):  # noqa: F811
    return Results(models, tmp_path_factory.mktemp("paged"), SCHEDULES)


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_paged_telemetry_equals_the_reference(results, name):
    check_schedule(results, name)


def test_paged_schedules_reach_what_they_are_for(results):
    """Preemption and a resume prefill happened, a prefix page matched, the
    budget made interference, and the queue-full refusal counted."""
    m = {n: results.get(n, True)["metrics"] for n in SCHEDULES}
    assert m["preempt"]["ditl_serving_preemptions"][1] >= 1
    kinds = {dict(s[2]).get("kind") for s in results.get("preempt", True)["spans"]
             if s[0] == "engine.prefill"}
    assert kinds == {"prompt", "resume"}
    assert m["prefix"]["ditl_serving_request_ttft_cache_hit_seconds"][1] == 1
    assert m["prefix"]["ditl_serving_prefix_cache_hit_tokens"][1] == 48
    assert m["chunked"]["ditl_serving_tpot_interference_seconds"][1] > 0
    assert m["queue_full"]["ditl_serving_queue_full"][1] == 1
    assert len(PROMPTS) == m["more_than_slots"]["ditl_serving_requests_completed"][1]
