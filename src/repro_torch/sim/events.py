"""Discrete-event simulator core: a deterministic priority-queue clock over
the event-shaped data layer.

Port of the JAX package's ``sim/events.py`` (pure numpy, copied). The
sources are CSR contact windows (``repro_torch.core.contact_plan``), packed
eclipse terminator crossings (``repro_torch.orbit.eclipse.PackedEclipse``
inside ``repro_torch.sim.energy``) and CSR fault outage / reset / storm
timelines (``repro_torch.sim.faults``). Two primitives turn them into one
discrete-event clock:

:class:`EventQueue`
    A heap of :class:`Event` records with the **deterministic ordering
    contract** ``(t, priority, key, seq)``: time first, then the event
    kind's canonical priority (state transitions resolve before the
    decisions that read them at the same instant), then ``key`` (the
    satellite / cluster index — so simultaneous returns pop in satellite
    order, the FedBuff tie-break), then the insertion sequence number as
    the last-resort tiebreaker.

:class:`WorldTimeline`
    The *world* events — contact-window open/close, eclipse entry/exit,
    fault outage/recovery, radiation resets, storms — drawn once from the
    CSR arrays as globally time-sorted per-kind streams.
    :meth:`WorldTimeline.advance_through` resolves every world event up to
    a decision time in one vectorized pass per kind (a single
    ``np.searchsorted`` cursor advance); :meth:`events_between` and
    :meth:`iter_events` materialize the same events one at a time, in
    queue order.

Decision events (round barriers for the synchronous engines, client
returns for FedBuffSat) go through the :class:`EventQueue`; bulk world
events go through the batched timeline. ``repro_torch.core.spaceify``
consumes both.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

# -- event taxonomy ---------------------------------------------------------
# World events (state transitions; resolve first at equal timestamps, in
# this priority order) ...
CONTACT_OPEN = "contact_open"        # a GS window's start time
CONTACT_CLOSE = "contact_close"      # a GS window's end time
ECLIPSE_ENTRY = "eclipse_entry"      # terminator crossing into umbra
ECLIPSE_EXIT = "eclipse_exit"        # terminator crossing into sunlight
FAULT_DOWN = "fault_down"            # outage interval start
FAULT_UP = "fault_up"                # outage interval end (recovery)
RADIATION_RESET = "radiation_reset"  # SEU payload reboot
STORM_BEGIN = "storm_begin"          # correlated storm hits a cluster
STORM_END = "storm_end"              # storm footprint clears
BATTERY_FLOOR = "battery_floor"      # SoC crossed below the gating floor
BATTERY_RECOVER = "battery_recover"  # SoC recovered above the floor
# ... then decision events (the FL consumers).
TRAIN_DONE = "train_done"            # a client's local training completed
CLIENT_RETURN = "client_return"      # async delivery (FedBuff's heap event)
ROUND_BARRIER = "round_barrier"      # synchronous FL decision point

#: Canonical priority of each kind inside one timestamp. World transitions
#: (lower values) apply before decisions read the state — matching the CSR
#: query conventions (an outage ending at t leaves the satellite available
#: at t; a window opening at t is usable at t).
PRIORITY: Dict[str, int] = {
    CONTACT_OPEN: 0, CONTACT_CLOSE: 1,
    ECLIPSE_ENTRY: 2, ECLIPSE_EXIT: 3,
    FAULT_DOWN: 4, FAULT_UP: 5, RADIATION_RESET: 6,
    STORM_BEGIN: 7, STORM_END: 8,
    BATTERY_FLOOR: 9, BATTERY_RECOVER: 10,
    TRAIN_DONE: 11, CLIENT_RETURN: 12, ROUND_BARRIER: 13,
}

WORLD_KINDS: Tuple[str, ...] = (
    CONTACT_OPEN, CONTACT_CLOSE, ECLIPSE_ENTRY, ECLIPSE_EXIT,
    FAULT_DOWN, FAULT_UP, RADIATION_RESET, STORM_BEGIN, STORM_END)


@dataclasses.dataclass(frozen=True)
class Event:
    """One scheduled occurrence. ``key`` is the satellite (or cluster)
    index the event concerns, -1 for fleet-level events; it is part of the
    ordering contract, so two clients returning at the same contact
    instant pop in satellite-index order."""
    t: float
    kind: str
    key: int = -1
    payload: object = None

    @property
    def priority(self) -> int:
        return PRIORITY[self.kind]


class EventQueue:
    """Deterministic discrete-event priority queue.

    Heap entries are ``(t, priority, key, seq, event)`` tuples, so pops
    are totally ordered by ``(t, priority, key)`` with the insertion
    sequence number ``seq`` only ever consulted between events that are
    fully identical on the first three fields (then insertion order
    wins — documented, and exercised by the property suite).

    **Past-push contract**: pushing an event strictly before the last
    popped timestamp raises ``ValueError`` *at the push* — failing at
    the producer, where the bug is, not at some later pop. Pushing
    *exactly at* the current clock is allowed and well-defined: the
    event is ordered by ``(priority, key, seq)`` against everything
    else at that instant (a zero-duration follow-up is legitimate
    scheduling; rewinding the clock is not). Pop times are therefore
    non-decreasing by construction; :meth:`pop` keeps an assert as a
    backstop against heap corruption.
    """

    def __init__(self):
        self._heap: List[Tuple[float, int, int, int, Event]] = []
        self._seq = 0
        self.t_last = -np.inf      # last popped timestamp (monotone)
        self.n_pushed = 0
        self.n_popped = 0

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)

    def push(self, t: float, kind: str, key: int = -1,
             payload: object = None) -> Event:
        ev = Event(float(t), kind, int(key), payload)
        self.push_event(ev)
        return ev

    def push_event(self, ev: Event) -> None:
        if ev.t < self.t_last:
            raise ValueError(
                f"event {ev.kind!r} (key={ev.key}) scheduled at t={ev.t} "
                f"but the clock has already popped t={self.t_last}: "
                "events may be pushed at or after the current clock, "
                "never into the past")
        heapq.heappush(self._heap,
                       (ev.t, ev.priority, ev.key, self._seq, ev))
        self._seq += 1
        self.n_pushed += 1

    def peek_time(self) -> Optional[float]:
        return self._heap[0][0] if self._heap else None

    def pop(self) -> Event:
        t, _, _, _, ev = heapq.heappop(self._heap)
        assert t >= self.t_last, "event queue popped into the past"
        self.t_last = t
        self.n_popped += 1
        return ev

    def pop_until(self, t: float) -> List[Event]:
        """Pop (in order) every event with timestamp <= ``t``."""
        out = []
        while self._heap and self._heap[0][0] <= t:
            out.append(self.pop())
        return out


class EventStats:
    """Per-kind counters of everything the clock resolved, plus how it was
    resolved: ``batched_passes`` vectorized :meth:`advance_through` calls
    vs per-event queue pops. ``SpaceifiedFL.run`` exposes one of these as
    ``algo.event_stats``."""

    def __init__(self):
        self.counts: Dict[str, int] = {}
        self.batched_passes = 0

    def add(self, kind: str, n: int = 1) -> None:
        if n:
            self.counts[kind] = self.counts.get(kind, 0) + int(n)

    def total(self) -> int:
        return sum(self.counts.values())

    def as_dict(self) -> Dict[str, int]:
        out = dict(sorted(self.counts.items()))
        out["total"] = self.total()
        out["batched_passes"] = self.batched_passes
        return out

    def __repr__(self):
        return f"EventStats({self.as_dict()})"


class WorldTimeline:
    """Globally time-sorted world-event streams over static CSR sources.

    Each source is one kind's complete (times, keys) arrays, sorted by
    ``(t, key)`` once at construction, with a cursor. The two consumption
    modes share cursors, so a caller can interleave them:

    * :meth:`advance_through` — the hot path: advance every cursor to
      ``t`` with one ``searchsorted`` per kind and account the skipped
      events in bulk (no per-event Python work);
    * :meth:`events_between` / :meth:`iter_events` — materialize the same
      events one :class:`Event` at a time in canonical queue order.

    Battery-floor crossings cannot be precomputed here — they depend on
    the activity the FL engines bill — so the engines report them via
    :meth:`note_eligibility`, which diffs the gating mask between
    decision points and accounts the crossings at the decision timestamp.
    """

    def __init__(self):
        self._kinds: List[str] = []
        self._times: List[np.ndarray] = []
        self._keys: List[np.ndarray] = []
        self._cursor: List[int] = []
        self.t = -np.inf
        self.stats = EventStats()
        self._elig_mask: Optional[np.ndarray] = None

    # -- construction ---------------------------------------------------
    def add_source(self, kind: str, times, keys) -> None:
        times = np.asarray(times, np.float64)
        keys = np.broadcast_to(np.asarray(keys, np.int64), times.shape)
        order = np.lexsort((keys, times))      # canonical (t, key) order
        self._kinds.append(kind)
        self._times.append(times[order])
        self._keys.append(keys[order].copy())
        self._cursor.append(0)

    @classmethod
    def for_fl(cls, plan, energy=None, faults=None) -> "WorldTimeline":
        """Build the world timeline of one FL run from the same engines
        the round loop queries: the contact plan's window arrays, the
        energy engine's terminator crossings, the fault engine's outage
        intervals and reset times. Sources whose subsystem is off are
        simply absent."""
        tl = cls()
        sat, starts, ends = plan.window_events()
        tl.add_source(CONTACT_OPEN, starts, sat)
        tl.add_source(CONTACT_CLOSE, ends, sat)
        if energy is not None:
            sat, t, entering = energy.transition_events()
            tl.add_source(ECLIPSE_ENTRY, t[entering], sat[entering])
            tl.add_source(ECLIPSE_EXIT, t[~entering], sat[~entering])
        if faults is not None:
            sat, starts, ends = faults.outage_events()
            tl.add_source(FAULT_DOWN, starts, sat)
            tl.add_source(FAULT_UP, ends, sat)
            sat, t = faults.reset_events()
            tl.add_source(RADIATION_RESET, t, sat)
            if getattr(faults, "has_storms", False):
                # storm events are keyed by *cluster*, not satellite
                cluster, t_begin, t_end = faults.storm_timeline_events()
                tl.add_source(STORM_BEGIN, t_begin, cluster)
                tl.add_source(STORM_END, t_end, cluster)
        return tl

    # -- bulk accounting -------------------------------------------------
    def remaining(self) -> int:
        return sum(len(t) - c for t, c in zip(self._times, self._cursor))

    def advance_through(self, t: float) -> int:
        """Resolve every world event with timestamp <= ``t`` in one
        vectorized pass per kind: a single bisection advances each
        cursor, and the skipped events are accounted in bulk. Returns the
        number of events resolved. Idempotent at equal ``t``; never moves
        backwards."""
        t = float(t)
        if t < self.t:
            return 0
        n_total = 0
        for i, times in enumerate(self._times):
            c = self._cursor[i]
            j = int(np.searchsorted(times, t, side="right"))
            if j > c:
                self.stats.add(self._kinds[i], j - c)
                self._cursor[i] = j
                n_total += j - c
        self.t = t
        self.stats.batched_passes += 1
        return n_total

    def note_eligibility(self, mask, t: float) -> None:
        """Report the battery-gating mask at a decision point; crossings
        since the previous report are accounted as BATTERY_FLOOR /
        BATTERY_RECOVER events at ``t`` (the engines bill activity
        between decision points, so the exact crossing instant is not
        observable — the decision point is when the crossing matters)."""
        mask = np.asarray(mask, bool)
        if self._elig_mask is not None:
            self.stats.add(BATTERY_FLOOR,
                           int(np.sum(self._elig_mask & ~mask)))
            self.stats.add(BATTERY_RECOVER,
                           int(np.sum(~self._elig_mask & mask)))
        self._elig_mask = mask.copy()

    # -- per-event view (baseline / tests / tracing) ---------------------
    def events_between(self, t: float) -> List[Event]:
        """The same events :meth:`advance_through`(``t``) would resolve,
        materialized individually in canonical ``(t, priority, key)``
        order. Shares (and advances) the cursors; the per-kind counters
        are credited identically, so mixing modes keeps stats exact."""
        chunks_t, chunks_p, chunks_k, chunks_kind = [], [], [], []
        t = float(t)
        for i, times in enumerate(self._times):
            c = self._cursor[i]
            j = int(np.searchsorted(times, t, side="right"))
            if j > c:
                kind = self._kinds[i]
                chunks_t.append(times[c:j])
                chunks_k.append(self._keys[i][c:j])
                chunks_p.append(np.full(j - c, PRIORITY[kind]))
                chunks_kind.append(kind)
                self.stats.add(kind, j - c)
                self._cursor[i] = j
        self.t = max(self.t, t)
        if not chunks_t:
            return []
        ts = np.concatenate(chunks_t)
        ps = np.concatenate(chunks_p)
        ks = np.concatenate(chunks_k)
        kinds = np.concatenate([np.full(len(c), kind, object)
                                for c, kind in zip(chunks_t, chunks_kind)])
        order = np.lexsort((ks, ps, ts))
        return [Event(float(ts[i]), str(kinds[i]), int(ks[i]))
                for i in order]

    def iter_events(self, t_end: float = np.inf) -> Iterator[Event]:
        """Stream every remaining event up to ``t_end`` one at a time in
        canonical order (a merged walk over the sorted sources)."""
        heap = []
        for i, times in enumerate(self._times):
            c = self._cursor[i]
            if c < len(times) and times[c] <= t_end:
                heap.append((times[c], PRIORITY[self._kinds[i]],
                             int(self._keys[i][c]), i, c))
        heapq.heapify(heap)
        while heap:
            t, p, k, i, c = heapq.heappop(heap)
            yield Event(t, self._kinds[i], k)
            self.stats.add(self._kinds[i])
            self._cursor[i] = c + 1
            self.t = max(self.t, t)
            times = self._times[i]
            if c + 1 < len(times) and times[c + 1] <= t_end:
                heapq.heappush(heap, (times[c + 1],
                                      PRIORITY[self._kinds[i]],
                                      int(self._keys[i][c + 1]), i, c + 1))
