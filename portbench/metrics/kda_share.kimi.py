"""K9's (kernels/kda.py) device seconds over the device's busy seconds in
the profiled part of the window, in %."""


def read(run):
    t = run.trace
    device_s = sum(s for name, s in t.get("by_name", {}).items() if "kda_kernel" in name)
    if not device_s or not t.get("busy_s"):
        return None
    return 100.0 * device_s / t["busy_s"]
