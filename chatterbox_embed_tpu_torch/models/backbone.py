"""T3's backbone, chosen by its config (`T3Config.llama`): Llama_520M
(models/llama.py, a LlamaConfig), DeepSeek-V2 (models/deepseek_v2.py, a
DeepseekV2Config) or Kimi-Linear (models/kimi_linear.py, a
KimiLinearConfig). `of(cfg)` returns the backbone's module; all give T3
the same face, so T3 and its engine call it without asking which it is:

- `NAME`, and `UNSUPPORTED`: the features of `FEATURES` it does not run;
- `WHOLE_STEP`: whether the engine's decode step has no eager kernel
  between its parts, and is one piece (t3_engine.EngineStep) rather than
  pieces cut at K1;
- `SERVING_KERNELS`: the kernels its serving launches, by their names in
  the kernel table (kernels.table);
- `init(init, cfg)`: the params, held under T3's "llama" key;
- `kv_heads(params, cfg)` and `init_cache(cfg, batch, max_len, dtype,
  device, heads=None, route=False)`: the decode cache (dtype torch.int8
  the int8 cache; `route` a latent cache's routing record), a NamedTuple
  whose first field is sequence-major (layers, L, B, ...) and whose
  `ROW_STATE` fields, if any, hold a row's state whatever its length
  (layers, B, ...);
- `cache_bytes_per_token(cfg, dtype, int8)`: a row's cache bytes a token;
- `forward(params, x, pos_ids, attn_mask, cache, cache_pos, cfg, dtype,
  flash_start, flash_hole, collect_attn_layer, flash_span, remat, mesh)`
  -> (hidden, cache[, the alignment row]).

`check(cfg, **asked)` is the one refusal: each entry point that turns a
feature on (a pipeline's mesh or int8 weights, an engine, a generation, a
stream's first chunk, a train step) names what it asks for, and a feature
the backbone does not run raises NotImplementedError there.
"""
from __future__ import annotations

from . import deepseek_v2, kimi_linear, llama

FEATURES = {
    "int8_cache": "the int8 cache (CHATTERBOX_INT8_KV, kv_int8)",
    "int8_weights": "int8 weights (quantize_t3)",
    "fused_step": "the fused step K4 (CHATTERBOX_FUSED_STEP=1)",
    "mesh": "a mesh",
    "first_chunk": "the stream's first-chunk graph",
    "alignment": "the alignment guard",
    "training": "training (the train step, remat)",
}


def of(cfg):
    """The backbone module of a backbone config (T3Config.llama)."""
    if isinstance(cfg, deepseek_v2.DeepseekV2Config):
        return deepseek_v2
    return kimi_linear if isinstance(cfg, kimi_linear.KimiLinearConfig) else llama


def check(cfg, **asked: bool) -> None:
    """Raise NotImplementedError for the first feature asked for (a key of
    FEATURES set true) that cfg's backbone does not run."""
    bb = of(cfg)
    for name, on in asked.items():
        if name not in FEATURES:
            raise KeyError(f"backbone.check: unknown feature {name!r}")
        if on and name in bb.UNSUPPORTED:
            raise NotImplementedError(
                f"{FEATURES[name]} is not ported for the {bb.NAME} backbone: it runs without "
                + ", ".join(FEATURES[f] for f in FEATURES if f in bb.UNSUPPORTED))
