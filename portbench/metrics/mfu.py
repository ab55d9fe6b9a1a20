"""Model FLOPs of the work completed in the window's unprofiled part (T3's prefill and
decode on both CFG rows, S3Gen's conformer, estimator at every Euler step
on the CFG pair and HiFT, the S3 tokenizer; portbench/lib/work.py) over
the window at the card's bf16 peak, in %."""
from portbench.lib import work


def read(run):
    flops = run.counters.get("model_flops")
    return None if not flops else 100.0 * flops / (run.window_s * work.PEAK_OPS["bf16"])
