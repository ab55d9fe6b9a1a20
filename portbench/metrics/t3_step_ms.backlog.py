"""T3's decode step in the engine: the engine's own decode clock (host
time over its blocks, each ending in a device-to-host copy) over the
steps it ran in the window's unprofiled part, in ms."""


def read(run):
    c = run.counters
    if not c.get("steps"):
        return None
    return 1e3 * c["t_decode_s"] / c["steps"]
