"""The share of the profiled part of the window in which no kernel, copy or memset ran
on the card (the union of the profiler's device records), in %."""


def read(run):
    t = run.trace
    if not t.get("window_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
