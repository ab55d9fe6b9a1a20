"""tts-backlog's closed backlog through `serving.continuous.ContinuousServer`
on T3 with the Kimi-Linear backbone (`lib/model_kimi.py`): the same
traffic, server geometry and vocode flushes, the engine's step one CUDA
graph with the hybrid cache (latent rows, KDA states, conv windows), K9
and K7.

It is `server_backlog_dsv2.run` with the Kimi-Linear configuration's
modules in place of DeepSeek-V2's for the length of the run (the weights
`model_kimi`, the check `check_kimi`, the model FLOPs `work_kimi`), and
the KDA layers' device counters beside the MoE layers': with --trace 1
they are on from before the warm-up, the engine's graph captures them, and
their growth over the profiled part goes to the metrics as `profiled.moe.*`
and `profiled.kda.*`. The engine's routing record of a finished request
holds its first KDA layer's state (`t3_engine.KdaRoute`), which the check
holds to the reference's (`kda_state_rel`). As there, a request that the
server decodes again is judged by the draws of the decode that was served.
"""
from __future__ import annotations

from ..lib import check_kimi, model_kimi, work_kimi
from . import server_backlog_dsv2 as base

KDA = ("kda.calls", "kda.tokens", "kda.states_read", "kda.states_written")


def run(ctx) -> dict:
    swap = dict(model_dsv2=model_kimi, check_dsv2=check_kimi, work_dsv2=work_kimi,
                MOE=base.MOE + KDA)
    kept = {k: getattr(base, k) for k in swap}
    for k, v in swap.items():
        setattr(base, k, v)
    try:
        return base.run(ctx)
    finally:
        for k, v in kept.items():
            setattr(base, k, v)
