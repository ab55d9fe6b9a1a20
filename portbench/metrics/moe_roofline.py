"""K7 (kernels/moe_experts.py) against its roofline: the least time of
K7's calls in the profiled part of the window over K7's device time there
by kernel name, in %. The calls' bytes and operations come from the MoE
layers' device counters over the profiled part (`profiled.moe.*`: their
assignments and touched experts summed over the calls;
lib/work_dsv2.k7_work). Every call is bound by its bytes (a call's
operations outweigh them only past ~19,000 assignments, 295 operations a
byte), so the calls' summed bytes give the sum of their bounds."""
from portbench.lib import work, work_dsv2


def read(run):
    c = run.counters
    device_s = sum(s for name, s in run.trace.get("by_name", {}).items() if "moe_kernel" in name)
    if not device_s or not c.get("profiled.moe.calls"):
        return None
    cb = run.cfg["t3"]["backbone"]
    nbytes, ops = work_dsv2.k7_work(c["profiled.moe.assignments"],
                                    c["profiled.moe.experts_touched"], cb["hidden_size"],
                                    cb["moe_intermediate_size"])
    return 100.0 * work.bound_s(nbytes, ops) / device_s
