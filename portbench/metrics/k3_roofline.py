"""K3 (kernels/flash_attention.py) against its roofline: the least time
of every K3 call in the profiled part of the window, bound from its shapes and valid
keys (portbench/lib/work.py), over the device time of the kernels
launched inside those calls, in %."""
from portbench.lib import work


def read(run):
    calls = run.patches.records.get("k3", [])
    device_s = sum(s for name, s in run.trace.get("in_range", {}).get("k3", {}).items()
                   if "masked_attention" in name)
    if not calls or not device_s:
        return None
    bound = 0.0
    for (b, t, h, d), item, valid in calls:
        nbytes, ops = work.flash_attention_work(b, t, h, d, int(valid.sum()), item)
        bound += work.bound_s(nbytes, ops, "bf16" if item == 2 else "fp32")
    return 100.0 * bound / device_s
