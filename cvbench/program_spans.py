"""The program's own spans in a traced run, and what they split.

    python3 cvbench/program_spans.py --workload <cell> --seed <n> --seconds <s>

runs one cell traced, as ``run.py --trace 1`` does, and prints its result
line with two more entries: ``program_spans``, the readings below, and
``breakdown.idle_by_program_span``. The run is ``run.run_cell``'s own; the
Chrome trace is read once more for the spans that ``cvmatrix_tpu_torch``
opens (``cvmatrix_tpu_torch.utils.profiling.span``: ``user_annotation``
ranges named ``cvmatrix_tpu_torch.*`` on the thread of the harness's
spans), which ``tracing.read`` leaves out. A program without such spans
reads nothing: the entries are then absent.

Readings, each a mean over the traced totals of the program spans that
start inside a total's ``cvbench.total`` span:

- ``h2d_wait_ms``: summed duration of the ``h2d`` spans, the host's time in
  copies of fold rows and masks to the card, the wait for the stream that a
  blocking copy pays included;
- ``h2d_per_total``: their number;
- ``sources_ms`` and ``stats_ms``: the self time of the
  ``core.batch.sources`` and ``core.batch.stats`` spans, each span's
  duration less the part its nested program spans cover;
- ``reduce_fn_ms``: summed duration of the ``models.sweep.reduce_fn`` spans
  (cells whose entry reduces);
- ``chunks``: the ``core.batch.route.<route>`` spans by route.
"""

from __future__ import annotations

import bisect
import collections
import json
import sys
from pathlib import Path
from typing import Dict, List, Optional, Tuple

if __name__ == "__main__":
    # Run as a script: the package and the program come from the checkout.
    sys.path[0] = str(Path(__file__).resolve().parents[1])

PREFIX = "cvmatrix_tpu_torch."
H2D = PREFIX + "h2d"
SOURCES = PREFIX + "core.batch.sources"
STATS = PREFIX + "core.batch.stats"
REDUCE_FN = PREFIX + "models.sweep.reduce_fn"
ROUTE = PREFIX + "core.batch.route."
OUTSIDE = "outside the program"

Span = Tuple[float, float, str]


def load(path: str) -> List[Span]:
    """The program's spans ``(start, end, name)`` of the Chrome trace at
    ``path``, sorted by start: those of the thread that opened the
    ``cvbench.total`` spans."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    notes = [ev for ev in events
             if ev.get("ph") == "X" and "dur" in ev
             and ev.get("cat") == "user_annotation"]
    main = {ev.get("tid") for ev in notes
            if ev.get("name") == "cvbench.total"}
    return sorted(
        (float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]), ev["name"])
        for ev in notes
        if ev.get("tid") in main and ev.get("name", "").startswith(PREFIX))


def starting_in(program: List[Span], span) -> List[Span]:
    """The program spans that start inside ``span`` (``(start, end)``)."""
    starts = [p[0] for p in program]
    return program[bisect.bisect_left(starts, span[0]):
                   bisect.bisect_right(starts, span[1])]


def self_time(span: Span, program: List[Span]) -> float:
    """``span``'s duration less the part that the program spans nested in
    it cover (microseconds)."""
    s0, e0, _ = span
    covered, cur_s, cur_e = 0.0, None, None
    for s, e, _ in starting_in(program, (s0, e0)):
        if (s, e) == (s0, e0) or e > e0:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                covered += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        covered += cur_e - cur_s
    return (e0 - s0) - covered


def _mean(values) -> Optional[float]:
    values = list(values)
    return sum(values) / len(values) if values else None


def readings(totals: List[Tuple[float, float]],
             program: List[Span]) -> Dict[str, object]:
    """The readings of the module's docstring over the traced totals
    ``totals`` (``(start, end)`` each); ``{}`` where the program opened no
    span, ``reduce_fn_ms`` only where it opened ``reduce_fn`` spans."""
    per = [starting_in(program, t) for t in totals]
    if not any(per):
        return {}

    def total_ms(spans, name, measure):
        return sum(measure(sp) for sp in spans if sp[2] == name) / 1e3

    def duration(sp):
        return sp[1] - sp[0]

    def own(sp):
        return self_time(sp, program)

    out = {
        "h2d_wait_ms": _mean(total_ms(p, H2D, duration) for p in per),
        "h2d_per_total": _mean(sum(sp[2] == H2D for sp in p) for p in per),
        "sources_ms": _mean(total_ms(p, SOURCES, own) for p in per),
        "stats_ms": _mean(total_ms(p, STATS, own) for p in per),
    }
    if any(sp[2] == REDUCE_FN for p in per for sp in p):
        out["reduce_fn_ms"] = _mean(total_ms(p, REDUCE_FN, duration)
                                    for p in per)
    chunks = collections.Counter(sp[2][len(ROUTE):] for p in per for sp in p
                                 if sp[2].startswith(ROUTE))
    out["chunks"] = {r: n / len(per) for r, n in sorted(chunks.items())}
    return out


def idle_by_program_span(gaps, program: List[Span], top: int = 10) -> list:
    """The idle seconds of ``gaps`` (``(start, end)`` stretches in which no
    device operation runs) by the innermost program span that holds each
    gap's midpoint, or ``outside the program``; ``[label (n gaps),
    seconds]``, most first."""
    by_name: Dict[str, Tuple[list, list]] = {}
    for sp in program:  # spans of one name never overlap
        starts, spans = by_name.setdefault(sp[2], ([], []))
        starts.append(sp[0])
        spans.append(sp)
    idle = collections.Counter()
    count = collections.Counter()
    for s, e in gaps:
        t = (s + e) / 2
        label, best = OUTSIDE, float("-inf")
        for starts, spans in by_name.values():
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and spans[i][1] >= t and spans[i][0] > best:
                label, best = spans[i][2], spans[i][0]
        idle[label] += (e - s) / 1e6
        count[label] += 1
    return [[f"{n} ({count[n]} gaps)", v] for n, v in idle.most_common(top)]


def run_cell(name: str, seed: int, seconds: float, **kw) -> dict:
    """``run.run_cell`` traced, with the program's spans read from its
    trace; ``kw`` as there (the CPU tests' tiny path)."""
    from cvbench import run, tracing

    kept = {}
    read = tracing.read

    def read_both(path, least, entry):
        kept["program"] = load(path)
        kept["rec"] = read(path, least, entry)
        return kept["rec"]

    tracing.read = read_both
    try:
        result = run.run_cell(name, seed, seconds, True, **kw)
    finally:
        tracing.read = read
    rec, program = kept["rec"], kept["program"]
    got = readings(rec.spans("total"), program)
    if got:
        result["program_spans"] = got
        result.setdefault("breakdown", {})["idle_by_program_span"] = (
            idle_by_program_span(rec.gaps(), program))
    return result


def main(argv=None) -> int:
    import argparse

    from cvbench import run

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    cell = run.load_json("workloads", args.workload)
    run.clean_env(cell.get("env", {}))

    import torch

    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        run.say(f"cell {args.workload} needs {cell['chips']} CUDA card(s)")
        return 3
    print(json.dumps(run_cell(args.workload, args.seed, args.seconds)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
