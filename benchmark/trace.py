"""Spans of the traced run and their reduction to the device's busy time.

`RoundTracer` wraps the fused round's three bodies (`enter`, `epoch`,
`leave`) in spans named `fused.<body>` and traces a steady span of the
rounds with torch.profiler: the profiler starts at the enter of round
`start` of the chunk it is attached for, the span opens at the next
round's enter and closes `rounds` rounds later, once the card has
finished them. The traced run attaches it for one chunk after the
window has closed, so the window's own clocks and counters stay
untraced; the bodies are put back afterwards.

`reduce_events` turns the profiler's events into the device's busy and
idle time over the span, the device operations that took most of it, and
the longest idle gaps, each named by what the host was doing when it
began (the innermost span and runtime call then open).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

SPAN = "bench.span"
# the prefixes of the spans this module and the probes open
ANNOTATIONS = ("fused.", "bench.")
TOP = 10

# (kind "cpu" | "device", name, start ns, end ns)
Event = Tuple[str, str, int, int]


class RoundTracer:
    def __init__(self, start: int = 4, rounds: int = 2):
        self.start, self.rounds = start, rounds
        self.enters = 0
        self.prof = None
        self.mark = None
        self.stopped = False
        self._orig: Dict[str, object] = {}

    def attach(self, fused) -> None:
        from torch.profiler import record_function
        for name in ("enter", "epoch", "leave"):
            body = getattr(fused, name)
            self._orig[name] = body

            def call(body=body, name=name):
                if name == "enter":
                    self._on_enter()
                with record_function(f"fused.{name}"):
                    body()
            setattr(fused, name, call)

    def _on_enter(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function
        at, self.enters = self.enters, self.enters + 1
        if at == self.start:
            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=activities)
            self.prof.start()
        elif at == self.start + 1:
            self.mark = record_function(SPAN)
            self.mark.__enter__()
        elif at == self.start + 1 + self.rounds:
            self._stop()

    def _stop(self) -> None:
        import torch
        if self.prof is None or self.stopped:
            return
        if self.mark is not None:
            self.mark.__exit__(None, None, None)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.stop()
        self.stopped = True

    def reduce(self) -> Optional[Dict]:
        """The traced span's reduction (reduce_events), or None."""
        if self.prof is None or self.mark is None:
            return None
        return reduce_events(profiler_events(self.prof))

    def detach(self, fused) -> None:
        self._stop()
        for name, body in self._orig.items():
            setattr(fused, name, body)


def profiler_events(prof) -> List[Event]:
    """(kind, name, start_ns, end_ns) of every event the profiler kept; a
    span's mirror on the device's timeline is not a device operation and
    is left out."""
    out: List[Event] = []
    for e in prof.profiler.kineto_results.events():
        kind = "cpu" if str(e.device_type()).endswith("CPU") else "device"
        if kind == "device" and e.name().startswith(ANNOTATIONS):
            continue
        out.append((kind, e.name(), int(e.start_ns()), int(e.end_ns())))
    return out


def _union(intervals: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def _label(cpu: Sequence[Event], t: int) -> str:
    """What the host was doing at t: the innermost span (`fused.*`,
    `bench.*`) and the innermost other host event open then."""
    spans = [c for c in cpu if c[2] <= t < c[3] and c[1] != SPAN
             and c[1].startswith(ANNOTATIONS)]
    calls = [c for c in cpu if c[2] <= t < c[3]
             and not c[1].startswith(ANNOTATIONS)]
    span = min(spans, key=lambda c: c[3] - c[2])[1] if spans else "host"
    call = min(calls, key=lambda c: c[3] - c[2])[1] if calls else "python"
    return f"{span}/{call}"


def reduce_events(events: Sequence[Event]) -> Optional[Dict]:
    """busy_s, window_s, device_ops and idle_gaps over the span: from the
    opening of the `bench.span` mark to the end of the last device
    operation; None without a mark or a device operation in it."""
    marks = [e for e in events if e[0] == "cpu" and e[1] == SPAN]
    if not marks:
        return None
    t0 = marks[0][2]
    dev = [(max(s, t0), e, name) for kind, name, s, e in events
           if kind == "device" and e > t0]
    if not dev:
        return None
    t1 = max(e for _, e, _ in dev)
    busy = _union([(s, e) for s, e, _ in dev if e > s])
    busy_ns = sum(e - s for s, e in busy)
    by_op: Dict[str, int] = {}
    for s, e, name in dev:
        by_op[name] = by_op.get(name, 0) + max(e - s, 0)
    cpu = [e for e in events if e[0] == "cpu"]
    gaps, at = [], t0
    for s, e in busy:
        if s > at:
            gaps.append((s - at, at))
        at = max(at, e)
    gaps.sort(reverse=True)
    return {"busy_s": busy_ns / 1e9, "window_s": (t1 - t0) / 1e9,
            "device_ops": [[name, ns / 1e9] for name, ns in sorted(
                by_op.items(), key=lambda kv: -kv[1])[:TOP]],
            "idle_gaps": [[_label(cpu, start), ns / 1e9]
                          for ns, start in gaps[:TOP]]}
