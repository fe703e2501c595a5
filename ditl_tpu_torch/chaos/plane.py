"""Deterministic, seed-driven fault-injection plane: a copy of the JAX
package's ``chaos/plane.py`` (stdlib only).

One fault plane that every layer consults at instrumented seams, so a
class of failures (dying transports, slow-not-dead workers, torn
checkpoints) can be reproduced on demand from a seed:

- **Rules, not code**: a :class:`FaultRule` names a *site* (a documented
  seam, see :data:`SITES`), an *action* (``delay`` / ``error`` /
  ``corrupt`` / ``hang`` / ``kill``), and *triggers* (probability,
  at-step, at-Nth-call, per-process, max-fire-count). Rules parse from a
  compact spec string (``parse_rules``).
- **Deterministic**: each rule owns a ``random.Random`` stream derived
  from ``sha256(seed, site, action, rule-index)`` and consultation counts
  are per-site, so the same seed and the same per-site call sequence fire
  the identical fault sequence.
- **Crash-survivable**: with a ``state_path``, fire counts persist
  (atomic tmp+rename, written before ``kill`` executes) so ``max=1``
  holds across process relaunches.

:data:`SITES` lists the reference's seams, so rule strings parse as they do
there; of them, the port consults ``client.request`` (``client/llm.py``).
The ``chaos`` config section and the event journal that records each
injection are not ported (ROADMAP.md): ``arm`` takes a plane built by the
caller. The disarmed fast path is one module-global ``None`` check.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import random
import signal
import threading
import time

from ditl_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

__all__ = [
    "ACTIONS",
    "CORRUPT_SITES",
    "SITES",
    "STEP_SITES",
    "Fault",
    "FaultPlane",
    "FaultRule",
    "InjectedFault",
    "arm",
    "arm_chaos",
    "disarm",
    "get_plane",
    "injected_summary",
    "maybe_inject",
    "parse_rules",
]

ACTIONS = ("delay", "error", "corrupt", "hang", "kill")

# `delay`/`error`/`hang`/`kill` are executed by the plane itself, so every
# site supports them; `corrupt` must be APPLIED by the seam (only it knows
# what "corrupt" means for its data), so a corrupt rule anywhere else would
# journal an injection that never happened — rejected at parse time.
CORRUPT_SITES = frozenset({
    "data.batch", "ckpt.save", "kvtier.swap_in", "adapter.load",
})

# Seams that consult the plane with a `step=` value. A `step=` trigger
# anywhere else compares against None and silently never fires — the same
# drill-passes-by-testing-nothing failure as a typo'd site, so it is
# rejected at parse time too (`call=` is the per-request trigger there).
STEP_SITES = frozenset({
    "ckpt.save", "elastic.heartbeat", "elastic.spawn", "engine.tick",
})

# The instrumented seams. A rule naming any other site is rejected at parse
# time (reject-don't-drop: a typo'd site would silently never fire and the
# drill would "pass" by testing nothing).
SITES = {
    "data.batch": "data/loader.py: producer side, before each host batch",
    "ckpt.save": "train/checkpoint.py: a checkpoint save commit "
                 "(kill/corrupt tear the just-committed step dir)",
    "ckpt.restore": "train/checkpoint.py: before reading a checkpoint",
    "elastic.heartbeat": "runtime/elastic.py: worker liveness publication",
    "elastic.spawn": "runtime/elastic.py: controller before spawning a "
                     "pod generation",
    "engine.tick": "infer/continuous.py: one scheduler tick",
    "server.request": "infer/server.py: a device-occupying HTTP request",
    "gateway.relay": "gateway/gateway.py: one upstream relay attempt "
                     "(error = simulated connection failure -> failover)",
    "client.request": "client/llm.py: one remote-LLM HTTP attempt "
                      "(error = simulated transport failure -> retry path)",
    "incident.dump": "telemetry/incident.py: between writing a bundle's "
                     "tmp dir and the publishing rename (kill = torn-"
                     "bundle drill: --list must skip it, the next manager "
                     "sweeps it)",
    "supervisor.action": "gateway/autoscale.py: inside the fleet-mutation "
                         "lock, before an autoscale/remediation action "
                         "executes (delay = widen the race window against "
                         "crash recovery / rolling restarts; error = a "
                         "failed actuation -> action.failed outcome)",
    "kvtier.spill": "infer/continuous.py: before the per-tick host-tier "
                    "spill batch (error = batch dropped and counted — the "
                    "pages simply re-prefill on their next miss; kill = a "
                    "real death mid-spill)",
    "kvtier.swap_in": "infer/continuous.py: before a host-tier swap-in at "
                      "admission (corrupt = bit-flip the stored entry — "
                      "the crc must detect, drop, and count it, never "
                      "serve it; error = treated as a tier miss, the "
                      "admission prefills)",
    "kv.handoff": "gateway/gateway.py: the prefill->decode KV handoff "
                  "orchestration on the relay leg (error/delay = a lost or "
                  "slow handoff leg -> fallback to plain relay and "
                  "re-prefill with zero client-visible failures)",
    "adapter.load": "infer/adapters.py: a hot adapter load, after the disk "
                    "read and before the crc verify (corrupt = bit-flip "
                    "the adapter bytes — the manifest crc must refuse the "
                    "load cleanly, nothing reaches the device; error = a "
                    "failed load -> counted, journaled, base keeps "
                    "serving)",
    "adapter.publish": "gateway/publish.py: one per-replica hop of a "
                       "fleet-wide adapter publication (error = the hop "
                       "dies mid-publish -> that replica keeps its old "
                       "verified adapter, the fallback is counted and the "
                       "journal chain shows which replicas flipped)",
    "loop.block": "gateway/evloop.py: inside the event loop's tick "
                  "callback (delay = a REAL single-threaded loop stall — "
                  "every connected stream freezes; the stall drill "
                  "expects the lag watchdog to convict this exact "
                  "file:line in the loop.stall incident bundle)",
    "bulk.dispatch": "gateway/bulk.py: one bulk work-item dispatch "
                     "attempt, after its bulk.dispatch journal row and "
                     "before the relay (kill = the mid-job gateway death "
                     "the resume drill injects — a restarted manager must "
                     "re-dispatch at most the in-flight window; error = a "
                     "transport fault riding the item's ordinary retry "
                     "path; the call= trigger picks which item dies)",
    "gateway.crash": "gateway/replica.py: the supervisor loop, once per "
                     "supervision pass (kill = SIGKILL the GATEWAY process "
                     "itself — the crash-recovery drill: the crash row is "
                     "journaled line-buffered before the kill lands, and a "
                     "--recover relaunch must adopt every still-alive "
                     "replica instead of restarting it; the call= trigger "
                     "picks which pass dies)",
}


class InjectedFault(RuntimeError):
    """Raised by an ``error`` rule at its seam. Deliberately a RuntimeError
    (not ValueError): an injected fault must ride the same handling path a
    genuine infrastructure failure would — never the client-error path."""

    def __init__(self, site: str, detail: str = ""):
        super().__init__(
            f"chaos: injected fault at {site}" + (f" ({detail})" if detail else "")
        )
        self.site = site


@dataclasses.dataclass(frozen=True)
class FaultRule:
    """One injection rule. Trigger predicates AND together; ``-1`` = any.

    ``at_call`` counts consultations of the rule's site (1-based) — the
    "at-request" trigger for seams consulted once per request/batch/tick.
    ``proc`` matches the process id the plane was armed with (pod drills
    target one worker). ``max_count`` caps total fires (0 = unlimited);
    with a persisted plane the cap survives relaunches.
    """

    site: str
    action: str
    p: float = 1.0
    at_step: int = -1
    at_call: int = -1
    proc: int = -1
    max_count: int = 0
    delay_s: float = 0.05
    hang_s: float = 30.0

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(
                f"unknown chaos site {self.site!r}; instrumented sites: "
                f"{sorted(SITES)}"
            )
        if self.action not in ACTIONS:
            raise ValueError(
                f"unknown chaos action {self.action!r} (one of {ACTIONS})"
            )
        if not 0.0 <= self.p <= 1.0:
            raise ValueError(f"chaos rule p must be in [0, 1], got {self.p}")
        if self.action == "corrupt" and self.site not in CORRUPT_SITES:
            raise ValueError(
                f"chaos action 'corrupt' is not applied at site "
                f"{self.site!r} (sites that implement it: "
                f"{sorted(CORRUPT_SITES)}) — the rule would journal "
                f"injections that never happen"
            )
        if self.at_step >= 0 and self.site not in STEP_SITES:
            raise ValueError(
                f"site {self.site!r} is not consulted with a step, so a "
                f"step= trigger would never fire (step-carrying sites: "
                f"{sorted(STEP_SITES)}; use call= there instead)"
            )


@dataclasses.dataclass(frozen=True)
class Fault:
    """A triggered fault, returned to seams that orchestrate the action
    themselves (``corrupt`` always; ``kill``/``error`` when the site
    declared them in ``handles``)."""

    site: str
    action: str
    rule: FaultRule
    count: int  # how many times this rule has fired (1-based)
    call: int  # the site consultation index that triggered (1-based)

    def kill_now(self) -> None:
        """Execute a deferred ``kill``: SIGKILL self — uncatchable, the
        host-crash/OOM-kill class only an out-of-process supervisor heals."""
        os.kill(os.getpid(), signal.SIGKILL)


# Spec-string keys -> FaultRule fields (the dotted-override surface).
_SPEC_KEYS = {
    "p": ("p", float),
    "step": ("at_step", int),
    "call": ("at_call", int),
    "proc": ("proc", int),
    "max": ("max_count", int),
    "delay": ("delay_s", float),
    "hang": ("hang_s", float),
}


def parse_rules(spec: str) -> tuple[FaultRule, ...]:
    """Parse a rule spec string: ``site:action[@k=v,k=v];site:action...``

    Example: ``"ckpt.save:kill@step=4,max=1;data.batch:delay@p=0.1,delay=0.02"``
    Keys: ``p`` (probability), ``step`` (at_step), ``call`` (at-Nth site
    consultation), ``proc`` (process id), ``max`` (max fires), ``delay``
    (delay seconds), ``hang`` (hang seconds)."""
    rules: list[FaultRule] = []
    for part in (p.strip() for p in spec.split(";")):
        if not part:
            continue
        head, _, tail = part.partition("@")
        if ":" not in head:
            raise ValueError(
                f"chaos rule must be site:action[@k=v,...], got {part!r}"
            )
        site, action = (s.strip() for s in head.split(":", 1))
        kwargs: dict = {}
        if tail:
            for kv in tail.split(","):
                if "=" not in kv:
                    raise ValueError(
                        f"chaos rule option must be k=v, got {kv!r} in {part!r}"
                    )
                k, v = (s.strip() for s in kv.split("=", 1))
                if k not in _SPEC_KEYS:
                    raise ValueError(
                        f"unknown chaos rule option {k!r} in {part!r} "
                        f"(one of {sorted(_SPEC_KEYS)})"
                    )
                field, cast = _SPEC_KEYS[k]
                kwargs[field] = cast(v)
        rules.append(FaultRule(site=site, action=action, **kwargs))
    return tuple(rules)


class FaultPlane:
    """Seed-driven fault plane consulted at instrumented seams.

    Thread-safe: seams are consulted from HTTP handler threads, the
    prefetch producer, and the engine driver concurrently; the lock covers
    only the (cheap) trigger decision — sleeps and kills run outside it.
    """

    def __init__(
        self,
        seed: int = 0,
        rules: str | tuple[FaultRule, ...] | list[FaultRule] = (),
        *,
        journal=None,
        process_id: int = 0,
        state_path: str = "",
    ):
        self.seed = int(seed)
        self.rules: tuple[FaultRule, ...] = (
            parse_rules(rules) if isinstance(rules, str) else tuple(rules)
        )
        self.journal = journal
        self.process_id = int(process_id)
        self.state_path = state_path
        self._lock = threading.Lock()
        self._site_calls: dict[str, int] = {}
        self._fired: dict[int, int] = {}
        # (site, action) -> fire count, for attribution in summaries.
        self.injected: dict[tuple[str, str], int] = {}
        self._rngs: dict[int, random.Random] = {}
        if state_path:
            self._load_state()

    # -- determinism ---------------------------------------------------------

    def _rng(self, rule_idx: int) -> random.Random:
        rng = self._rngs.get(rule_idx)
        if rng is None:
            rule = self.rules[rule_idx]
            digest = hashlib.sha256(
                f"{self.seed}/{rule.site}/{rule.action}/{rule_idx}".encode()
            ).digest()
            rng = random.Random(int.from_bytes(digest[:8], "big"))
            self._rngs[rule_idx] = rng
        return rng

    # -- crash-survivable fire counts ---------------------------------------

    def _load_state(self) -> None:
        try:
            with open(self.state_path) as f:
                state = json.load(f)
            self._fired = {int(k): int(v) for k, v in state.get("fired", {}).items()}
        except (OSError, ValueError):
            self._fired = {}

    def _persist_state(self) -> None:
        """Atomic write BEFORE the action executes: a ``kill`` that fires
        must already be on disk, or the relaunched process re-fires it and
        the drill kill-loops until the restart budget dies."""
        if not self.state_path:
            return
        tmp = f"{self.state_path}.tmp.{os.getpid()}"
        try:
            os.makedirs(os.path.dirname(self.state_path) or ".", exist_ok=True)
            with open(tmp, "w") as f:
                json.dump({"fired": {str(k): v for k, v in self._fired.items()}}, f)
            os.replace(tmp, self.state_path)
        except OSError:
            logger.exception("chaos: could not persist fire state")

    # -- the seam API --------------------------------------------------------

    def check(
        self,
        site: str,
        *,
        step: int | None = None,
        request: int | None = None,
        handles: tuple[str, ...] = (),
    ) -> Fault | None:
        """Consult the plane at ``site``. Executes ``delay``/``hang``
        (sleeps) and ``error`` (raises :class:`InjectedFault`) itself;
        returns the :class:`Fault` for ``corrupt`` (always site-applied)
        and for any action listed in ``handles`` (the seam orchestrates —
        e.g. checkpoint save tears the step dir before a ``kill``).
        Returns None when nothing fires."""
        with self._lock:
            n = self._site_calls.get(site, 0) + 1
            self._site_calls[site] = n
            fault: Fault | None = None
            for idx, rule in enumerate(self.rules):
                if rule.site != site:
                    continue
                if rule.proc >= 0 and rule.proc != self.process_id:
                    continue
                if rule.at_step >= 0 and step != rule.at_step:
                    continue
                if rule.at_call >= 0 and n != rule.at_call:
                    continue
                if rule.max_count and self._fired.get(idx, 0) >= rule.max_count:
                    continue
                if rule.p < 1.0 and self._rng(idx).random() >= rule.p:
                    continue
                self._fired[idx] = self._fired.get(idx, 0) + 1
                key = (site, rule.action)
                self.injected[key] = self.injected.get(key, 0) + 1
                fault = Fault(site=site, action=rule.action, rule=rule,
                              count=self._fired[idx], call=n)
                self._persist_state()
                break
        if fault is None:
            return None
        self._record(fault, step=step, request=request)
        return self._execute(fault, handles)

    def _record(self, fault: Fault, *, step, request) -> None:
        attrs = {"site": fault.site, "action": fault.action,
                 "call": fault.call, "fired": fault.count}
        if step is not None:
            attrs["step"] = int(step)
        if request is not None:
            attrs["request"] = int(request)
        logger.warning("chaos: injecting %s at %s (call %d)",
                       fault.action, fault.site, fault.call)
        if self.journal is not None:
            # Line-buffered journal: on disk before any sleep/raise/kill.
            self.journal.event("chaos.inject", **attrs)

    def _execute(self, fault: Fault, handles: tuple[str, ...]) -> Fault | None:
        if fault.action in handles or fault.action == "corrupt":
            return fault
        if fault.action == "delay":
            time.sleep(fault.rule.delay_s)
            return None
        if fault.action == "hang":
            time.sleep(fault.rule.hang_s)
            return None
        if fault.action == "error":
            raise InjectedFault(fault.site, f"call {fault.call}")
        fault.kill_now()  # "kill": does not return
        return None  # unreachable; keeps type checkers honest

    def summary(self) -> dict:
        """Bench-JSON attribution: what was configured and what actually
        fired — perf under fault is only interpretable with this attached."""
        return {
            "seed": self.seed,
            "rules": [f"{r.site}:{r.action}" for r in self.rules],
            "injected": {
                f"{site}:{action}": n
                for (site, action), n in sorted(self.injected.items())
            },
        }


# -- global arming -----------------------------------------------------------

_PLANE: FaultPlane | None = None


def arm(plane: FaultPlane) -> FaultPlane:
    """Install ``plane`` as the process-global fault plane."""
    global _PLANE
    _PLANE = plane
    return plane


def disarm() -> None:
    global _PLANE
    _PLANE = None


def get_plane() -> FaultPlane | None:
    return _PLANE


def maybe_inject(site: str, **kwargs) -> Fault | None:
    """The seam entry point. Disarmed cost: one global read + None check."""
    plane = _PLANE
    if plane is None:
        return None
    return plane.check(site, **kwargs)


def injected_summary() -> dict | None:
    """The armed plane's :meth:`FaultPlane.summary`, or None when disarmed,
    so perf-under-fault rows are attributable."""
    plane = _PLANE
    return None if plane is None else plane.summary()


def arm_chaos(chaos_cfg, *, journal=None, process_id: int = 0,
              state_dir: str = "") -> FaultPlane | None:
    """Arm the global plane from a chaos config section (the reference's
    ``ChaosConfig``: ``rules``, ``seed``, ``journal_dir``).

    No rules -> no-op (an already-armed plane, e.g. from a test, is left
    alone). ``journal`` defaults to a dedicated per-process chaos journal
    under ``chaos_cfg.journal_dir`` when that is set. ``state_dir`` (or
    ``chaos_cfg.journal_dir``) persists fire counts across relaunches so
    ``max=N`` caps survive the very kills they inject."""
    if not getattr(chaos_cfg, "rules", ""):
        return None
    state_dir = state_dir or chaos_cfg.journal_dir
    state_path = (
        os.path.join(state_dir, f"chaos-state-{process_id}.json")
        if state_dir else ""
    )
    if journal is None and chaos_cfg.journal_dir:
        raise NotImplementedError(
            "chaos journal_dir: the event journal (telemetry/journal.py) is not "
            "ported to PyTorch yet (see ROADMAP.md); pass journal= or leave "
            "journal_dir empty")
    return arm(FaultPlane(
        seed=chaos_cfg.seed, rules=chaos_cfg.rules, journal=journal,
        process_id=process_id, state_path=state_path,
    ))
