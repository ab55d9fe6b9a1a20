"""K1 (kernels/flash_decode.py) against its roofline: the least time of
every K1 call in the profiled part of the window, each bound from its shapes (live slots
and rows only, portbench/lib/work.py), over K1's device time by kernel
name, in %."""
from portbench.lib import work


def read(run):
    calls = run.patches.records.get("k1", [])
    device_s = sum(s for name, s in run.trace.get("by_name", {}).items()
                   if "decode_kernel" in name)
    if not calls or not device_s:
        return None
    bound = 0.0
    steps = {}
    for shape, item, pos, start, hole, span in calls:
        steps.setdefault(id(span), [span, hole, shape, item, pos, start, 0])[6] += 1
    for span, hole, (b, h, d), item, pos, start, n in steps.values():
        spans = (span.cpu().tolist() if span is not None else [[start, pos]] * b)
        holes = hole.cpu().tolist() if hole is not None else [[0, 0]] * b
        nbytes, ops = work.decode_attention_work(spans, holes, h, d, item)
        bound += n * work.bound_s(nbytes, ops)
    return 100.0 * bound / device_s
