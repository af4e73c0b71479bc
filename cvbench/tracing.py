"""The traced run's record: the benchmark's own spans and the device's
operations, read from a ``torch.profiler`` Chrome trace, and the sums the
per-layer metrics and the ``breakdown`` take from them.

Spans are ``torch.profiler.record_function`` ranges the harness opens
around each call into a layer (names ``cvbench.*``); in a traced total the
fit's and the folds' spans end with a ``synchronize()``, so the device
operations a span launched run inside it, and an operation belongs to the
span its start lies in. Device operations are the trace's kernels, copies
and fills. Times are in microseconds on the profiler's clock.
"""

from __future__ import annotations

import bisect
import collections
import json
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
PREFIX = "cvbench."

Interval = Tuple[float, float]


class Record:
    """The traced totals of one run.

    ``totals``: per traced total, ``{span name: (start, end)}`` of the
    ``cvbench.*`` spans it holds (``total``, ``fit``, ``folds`` and the
    entry's own). ``ops``: device operations ``(start, end, name)`` sorted
    by start. ``host``: the main thread's spans and top-level operators
    ``(start, end, label)``, for the idle gaps' labels. ``least``: the least
    seconds of the fit and of one total's folds (``costs``), ``entry``: the
    cell's entry.
    """

    def __init__(self, totals, ops, host, least, entry):
        self.totals: List[Dict[str, Interval]] = totals
        self.ops: List[Tuple[float, float, str]] = ops
        self.least: Dict[str, float] = least
        self.entry: str = entry
        self._starts = [o[0] for o in ops]
        # Spans of one name never overlap; nor do top-level operators.
        self._host_spans = {}
        for iv in sorted(h for h in host if h[2].startswith(PREFIX)):
            starts, ivs = self._host_spans.setdefault(iv[2], ([], []))
            starts.append(iv[0])
            ivs.append(iv)
        self._ops_host = sorted(h for h in host
                                if not h[2].startswith(PREFIX))
        self._op_starts = [h[0] for h in self._ops_host]

    # -- sums ---------------------------------------------------------- #

    def ops_in(self, span: Interval):
        """The device operations that start inside ``span``."""
        lo = bisect.bisect_left(self._starts, span[0])
        hi = bisect.bisect_right(self._starts, span[1])
        return self.ops[lo:hi]

    def busy(self, span: Interval) -> float:
        """Microseconds of ``span`` in which some device operation runs."""
        s0, e0 = span
        lo = max(bisect.bisect_left(self._starts, s0) - 64, 0)
        busy, cur_s, cur_e = 0.0, None, None
        for s, e, _ in self.ops[lo:bisect.bisect_right(self._starts, e0)]:
            s, e = max(s, s0), min(e, e0)
            if e <= s:
                continue
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        return busy

    def spans(self, name: str) -> List[Interval]:
        return [t[name] for t in self.totals if name in t]

    def busy_total(self) -> float:
        """Microseconds of the traced totals in which some device operation
        runs."""
        return sum(self.busy(sp) for sp in self.spans("total"))

    def wall_total(self) -> float:
        """Microseconds the traced totals took, from each one's start to its
        end; the time between totals (the next weights, the check's copies)
        is the harness's."""
        return sum(e - s for s, e in self.spans("total"))

    def gaps(self) -> List[Interval]:
        """The traced totals' stretches in which no device operation runs."""
        out = []
        for s0, e0 in self.spans("total"):
            cur = s0
            for s, e, _ in self.ops_in((s0, e0)):
                if s > cur:
                    out.append((cur, s))
                cur = max(cur, e)
            if e0 > cur:
                out.append((cur, e0))
        return out

    def host_label(self, t: float) -> str:
        """What the host was doing at ``t``: the innermost ``cvbench`` span
        and the top-level operator running then."""
        span = "cvbench (between spans)"
        best = float("-inf")
        for starts, ivs in self._host_spans.values():
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and ivs[i][1] >= t and ivs[i][0] > best:
                best, span = ivs[i][0], ivs[i][2]
        i = bisect.bisect_right(self._op_starts, t) - 1
        op = "python"
        if i >= 0 and self._ops_host[i][1] >= t:
            op = self._ops_host[i][2]
        return f"{span} / {op}"

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle time by
        what the host was doing, each in seconds over the traced totals."""
        by_op = collections.Counter()
        for sp in self.spans("total"):
            for s, e, name in self.ops_in(sp):
                by_op[name[:160]] += (e - s) / 1e6
        idle = collections.Counter()
        count = collections.Counter()
        for s, e in self.gaps():
            label = self.host_label((s + e) / 2)
            idle[label] += (e - s) / 1e6
            count[label] += 1
        return {
            "device_ops": [[n, v] for n, v in by_op.most_common(top)],
            "idle_gaps": [[f"{n} ({count[n]} gaps)", v]
                          for n, v in idle.most_common(top)],
        }


def read(path: str, least: Dict[str, float], entry: str) -> Record:
    """The record of the Chrome trace at ``path``."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans, ops, cpu = [], [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        s = float(ev["ts"])
        iv = (s, s + float(ev["dur"]), ev.get("name", ""))
        cat = ev.get("cat", "")
        if cat == "user_annotation" and iv[2].startswith(PREFIX):
            spans.append(iv + (ev.get("tid"),))
        elif cat in DEVICE_CATS:
            ops.append(iv)
        elif cat == "cpu_op":
            cpu.append(iv + (ev.get("tid"),))
    ops.sort()
    spans.sort()
    totals: List[Dict[str, Interval]] = []
    main_tid = None
    for s, e, name, tid in spans:
        if name == PREFIX + "total":
            totals.append({"total": (s, e)})
            main_tid = tid
        elif totals and s >= totals[-1]["total"][0]:
            totals[-1].setdefault(name[len(PREFIX):], (s, e))
    host = sorted([(s, e, n) for s, e, n, tid in spans if tid == main_tid]
                  + _top_level([c for c in cpu if c[3] == main_tid]))
    return Record(totals, ops, host, least, entry)


def _top_level(cpu) -> List[Tuple[float, float, str]]:
    """The operators that no other operator encloses."""
    out, end = [], float("-inf")
    for s, e, name, _ in sorted(cpu):
        if s >= end:
            out.append((s, e, name))
            end = e
    return out


def mean(values) -> Optional[float]:
    values = list(values)
    return sum(values) / len(values) if values else None
