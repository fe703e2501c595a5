"""Source annotations the static passes (ditl_tpu/analysis/) key on.
Stdlib-only and zero-cost at runtime — these exist so invariants live
NEXT TO the code they bind, where a reviewer (and the analyzer) can see
them, instead of in a test file three directories away.

Deliberately OUTSIDE the analysis package: hot-path modules (the engine,
the flight recorder, the metrics logger) import the marker, and pulling
it from ``ditl_tpu_torch.analysis`` would execute the whole analyzer framework
(rule registration and all) in every serving/training process just to
obtain a no-op decorator.

``@hot_path``
    Marks a function as device-sync-free by contract: the scheduler tick
    loop, flight-ring record paths, and the metrics record methods — the
    places where one stray ``jax.device_get`` / ``.block_until_ready()`` /
    ``float(device_array)`` stalls the pipeline for every request (the
    exact class of bug the journal's flush fix and the five-device_get
    pin were fighting). The ``blocking-transfer`` rule flags blocking
    spellings inside any function carrying this decorator; a genuinely
    host-side cast gets a reasoned pragma, never an unmark.

``@event_loop``
    Marks a function as running ON the gateway's single-threaded
    selectors loop: one blocking call there stalls every open
    connection and stream at once, not just one request. The
    ``event-loop-hygiene`` rule flags blocking spellings inside any
    function carrying this decorator — ``sleep``, ``.sendall(``,
    ``.join(``, and lock waits without a ``# guarded-by:`` witness.
    Plain ``.recv(`` is deliberately NOT flagged: loop-owned sockets are
    non-blocking by construction (``setblocking(False)`` at accept/
    detach), so recv returns immediately; the flagged spellings block
    (or raise mid-write, for sendall) regardless of socket mode.

``# guarded-by: <lock>`` (trailing comment on the attribute's defining
    assignment)
    Declares that an attribute may only be read or written inside a
    ``with self.<lock>:`` block of the same class. The ``lock-discipline``
    rule enforces it lexically; methods named ``*_locked`` are exempt by
    convention (they document that the CALLER holds the lock — the same
    contract the suffix already communicates to a human reader).
"""

from __future__ import annotations

__all__ = ["event_loop", "hot_path"]


def hot_path(fn):
    """No-op marker decorator: the decorated function promises to never
    block on a device transfer. Enforced statically by the
    ``blocking-transfer`` rule (ditl_tpu/analysis/rules_hotpath.py); the
    attribute below is for runtime introspection and tests."""
    fn.__ditl_hot_path__ = True
    return fn


def event_loop(fn):
    """No-op marker decorator: the decorated function runs on the
    gateway's selectors event loop and promises never to block it.
    Enforced statically by the ``event-loop-hygiene`` rule
    (ditl_tpu/analysis/rules_evloop.py); the attribute below is for
    runtime introspection and tests."""
    fn.__ditl_event_loop__ = True
    return fn
