"""K9 (kernels/kda.py) against its roofline: the least time of K9's calls in
the profiled part of the window over K9's device time there by kernel name,
in %. The calls' bytes and operations come from the KDA layers' device
counters over the profiled part (`profiled.kda.*`: the row-tokens through
K9 and the (row, head) states read and written, summed over the calls;
lib/work_kimi.k9_work), bound by the larger of the bytes over 3.35 TB/s and
the fp32 operations over 67 TFLOP/s, summed over the calls as one."""
from portbench.lib import work, work_kimi


def read(run):
    c = run.counters
    device_s = sum(s for name, s in run.trace.get("by_name", {}).items() if "kda_kernel" in name)
    if not device_s or not c.get("profiled.kda.calls"):
        return None
    la = run.cfg["t3"]["backbone"]["linear_attn_config"]
    nbytes, ops = work_kimi.k9_work(c["profiled.kda.tokens"], c["profiled.kda.states_read"],
                                    c["profiled.kda.states_written"], la["num_heads"],
                                    la["head_dim"], la["head_dim"])
    return 100.0 * work.bound_s(nbytes, ops, "fp32") / device_s
