"""A traced run of a cell with the program's spans on: the cell's result
line, as `run.py --trace 1` prints it, with a `spans` part beside it
(`lib/spans.py`): the engine's and the vocode flush's per-layer numbers,
the idle gaps by program span, the launches by program span and by vocode
dispatch, the share of idle time under the spans doing the work, and the
spans' totals. Not run
by the benchmark's runs.

    python3 portbench/span_run.py --workload <cell> --seeds 3 --seconds 50 [--spans 0]

With --spans 0 the same traced run leaves the spans off, for the cost of
having them on. One JSON line a seed on standard output.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent.parent


def _growth(now: dict, then: dict) -> dict:
    """Totals' growth: {"spans": {name: {calls, ns, self_ns}}, "counters"}."""
    sp = {k: {f: v[f] - then["spans"].get(k, {}).get(f, 0) for f in v}
          for k, v in now["spans"].items()}
    return {"spans": {k: v for k, v in sp.items() if v["calls"]},
            "counters": {k: v - then["counters"].get(k, 0) for k, v in now["counters"].items()}}


def instrument(run, spans_on: bool) -> dict:
    """Patch `run`'s window so that spans are on over it (when `spans_on`),
    their totals taken where the window opens, where the profiled part ends
    and where the window closes, and the trace read with the program's
    ranges. Returns what the run left: the context and the totals."""
    from chatterbox_embed_tpu_torch.utils import profiling
    from portbench.lib import spans, trace

    seen = {}
    read, open_window, mark, close_window = (trace.read, run.Ctx.open_window, run.Ctx._mark,
                                             run.Ctx.close_window)

    def read_both(events):
        events = list(events)
        out = read(spans.without_program_ranges(events))
        if out:
            out.update(spans.read(events))
            out["dispatch_launches"] = spans.dispatch_launches(events, profiling.spans())
        return out

    def opened(self, *a, **kw):
        seen.clear()
        seen["ctx"] = self
        profiling.reset()
        if spans_on:
            profiling.enable()
        seen["open"] = profiling.totals()
        return open_window(self, *a, **kw)

    def marked(self):
        mark(self)
        seen["mark"] = profiling.totals()

    def closed(self, *a, **kw):
        close_window(self, *a, **kw)
        profiling.disable()
        seen["close"] = profiling.totals()

    trace.read = read_both
    run.Ctx.open_window, run.Ctx._mark, run.Ctx.close_window = opened, marked, closed
    return seen


def readings(seen: dict) -> dict:
    from portbench.lib import spans
    unprofiled = _growth(seen["close"], seen["mark"])
    profiled = _growth(seen["mark"], seen["open"])
    fields = seen["ctx"].trace_data or {}
    r = SimpleNamespace(spans=unprofiled["spans"], span_counters=unprofiled["counters"],
                        profiled_span_counters=profiled["counters"], trace=fields)
    block = r.spans.get("engine.block")
    return {
        "metrics": spans.metrics(r),
        "span_gaps": spans.span_gaps(fields),
        "work_idle_share": spans.work_idle_share(fields),
        # the share of engine.block's time that its children's own times cover
        "block_children_share": (100.0 * (1 - block["self_ns"] / block["ns"])
                                 if block and block["ns"] else None),
        "launches_by_span": fields.get("launches_by_span", {}),
        "dispatch_launches": fields.get("dispatch_launches", []),
        "span_count": fields.get("span_count", {}),
        "unprofiled": unprofiled,
        "profiled": profiled,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_100_000_007)
    ap.add_argument("--seconds", type=float, default=50.0)
    ap.add_argument("--spans", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import run

    seen = instrument(run, bool(args.spans))
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        out, lines = run.run_cell(args.workload, seed, args.seconds, True)
        print("\n".join(lines), file=sys.stderr)
        out["spans"] = dict(readings(seen), on=bool(args.spans))
        print(json.dumps(dict(seed=seed, **out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
