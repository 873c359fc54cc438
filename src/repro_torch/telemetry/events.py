"""The degradation-event bus (a copy of the JAX package's
`telemetry/events.py`; host-only Python, no tensor is touched).

  * `record_event(kind, **details)` appends to the process-global queue
    AND fans out to every subscribed sink (engine tracers subscribe their
    bounded ring buffers through weakrefs, so a garbage-collected engine
    never leaks a subscription).
  * `consume_events()` drains the queue; `peek_events()` reads it.

Events are plain dicts with a "kind" key. The engine records
`slot_quarantined`, `request_rejected`, `deadline_expired` and
`request_failed` as it finalizes requests, `request_readmitted` for a
retry, `cache_poisoned` for an injected cache fault, `pallas_fallback`
when it steps down to the plain decode version, and `spec_autodisable` /
`spec_resume` as the acceptance ladder moves. `serving.faults` re-exports
the three functions below.
"""
from __future__ import annotations

import weakref
from typing import Callable, List


class EventBus:
    """A consumable event queue plus weakly-held subscriber fan-out."""

    def __init__(self):
        self._events: List[dict] = []
        self._subs: List[weakref.WeakMethod] = []

    def record(self, kind: str, **details) -> None:
        ev = {"kind": kind, **details}
        self._events.append(ev)
        if self._subs:
            alive = []
            for wm in self._subs:
                cb = wm()
                if cb is not None:
                    cb(dict(ev))
                    alive.append(wm)
            self._subs = alive

    def consume(self) -> List[dict]:
        out, self._events[:] = list(self._events), []
        return out

    def peek(self) -> List[dict]:
        return list(self._events)

    def subscribe(self, bound_method: Callable[[dict], None]) -> None:
        """Fan events out to `bound_method(event_dict)`, held through a
        WeakMethod, so the subscription dies with its owner."""
        self._subs.append(weakref.WeakMethod(bound_method))


BUS = EventBus()


def record_event(kind: str, **details) -> None:
    """Record one structured degradation event (quarantine, rejection,
    deadline, failure, retry, injected fault, step down, speculation
    disabled or resumed) on the global bus."""
    BUS.record(kind, **details)


def consume_events() -> List[dict]:
    """Drain the global queue (subscribed tracers keep their copies)."""
    return BUS.consume()


def peek_events() -> List[dict]:
    return BUS.peek()
