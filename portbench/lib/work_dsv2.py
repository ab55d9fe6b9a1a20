"""The yardstick's arithmetic for T3 on the DeepSeek-V2 backbone: K7's bytes
and operations, and the model FLOPs of a request, from shapes and the
published config.json's keys (`cb`, the configuration's t3.backbone).
"""
from __future__ import annotations


def k7_work(assignments: int, touched: int, d: int, f: int) -> tuple:
    """(bytes, operations) of K7 calls: each touched expert's three (d, f)
    bf16 matrices read once, each assignment's row read (bf16) and its
    output written (fp32); three products of 2 * d * f a row. Summed over
    calls, `assignments` and `touched` are the calls' sums."""
    return touched * 3 * d * f * 2 + assignments * d * (2 + 4), 6 * d * f * assignments


def active_params(cb: dict) -> int:
    """The backbone's parameters that one token-row multiplies through:
    attention's projections in every layer, the dense SwiGLU, and in each
    MoE layer the router, the chosen experts and the shared ones."""
    d, h = cb["hidden_size"], cb["num_attention_heads"]
    nope, rope, vd, r = (cb["qk_nope_head_dim"], cb["qk_rope_head_dim"], cb["v_head_dim"],
                         cb["kv_lora_rank"])
    attn = d * h * (nope + rope) + d * (r + rope) + r * h * (nope + vd) + h * vd * d
    dense = cb["first_k_dense_replace"]
    moe = cb["num_hidden_layers"] - dense
    f = cb["moe_intermediate_size"]
    moe_ffn = (d * cb["n_routed_experts"] + cb["num_experts_per_tok"] * 3 * d * f
               + 3 * d * f * cb["n_shared_experts"])
    return cb["num_hidden_layers"] * attn + dense * 3 * d * cb["intermediate_size"] + moe * moe_ffn


def t3_flops(t3: dict, context: int, tokens: int) -> float:
    """A request's T3 FLOPs, as lib/work.py counts Llama_520M's: the prefill
    of `context` positions and `tokens` decode steps on both CFG rows; two
    FLOPs a multiply-add over the active parameters, attention over the
    positions before in the published form (q.k over nope + rope, p.v over
    v a head), and the speech head."""
    cb = t3["backbone"]
    per_pos = 2 * active_params(cb)
    att = lambda ctx: (2 * cb["num_hidden_layers"] * cb["num_attention_heads"]
                       * (cb["qk_nope_head_dim"] + cb["qk_rope_head_dim"] + cb["v_head_dim"]) * ctx)
    head = 2 * cb["hidden_size"] * t3["speech_tokens_dict_size"]
    prefill = context * per_pos + sum(att(i + 1) for i in range(context)) + head
    decode = sum(per_pos + att(context + i + 1) + head for i in range(tokens))
    return 2 * (prefill + decode)
