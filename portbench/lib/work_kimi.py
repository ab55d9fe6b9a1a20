"""The yardstick's arithmetic for T3 on the Kimi-Linear backbone: K9's bytes
and operations, and the model FLOPs of a request, from shapes and the
published config.json's keys (`cb`, the configuration's t3.backbone). K7's
are lib/work_dsv2.k7_work's.
"""
from __future__ import annotations


def k9_work(tokens: int, states_read: int, states_written: int, heads: int, dk: int,
            dv: int) -> tuple:
    """(bytes, operations) of K9 calls over `tokens` row-tokens (summed over
    the calls; each a row and position the recurrence ran) and the (row,
    head) states they read and wrote: each state dk x dv fp32 read once and
    written once; each row-token's q, k, g (dk each), v and o (dv each) and
    beta, fp32, once a head; a state element's seven operations a token
    (the decay, and three multiply-adds: S'^T k, the update, S^T q)."""
    nbytes = ((states_read + states_written) * dk * dv * 4
              + tokens * heads * (3 * dk + 2 * dv + 1) * 4)
    return nbytes, 7 * tokens * heads * dk * dv


def _kinds(cb: dict) -> tuple:
    la = cb["linear_attn_config"]
    return len(la["kda_layers"]), len(la["full_attn_layers"])


def active_params(cb: dict) -> int:
    """The backbone's parameters that one token-row multiplies through: each
    KDA layer's projections (q, k, v, o, the low-rank decay and gate, beta)
    and conv taps; each MLA layer's projections; the dense SwiGLU; and in
    each MoE layer the router, the routed experts this card holds (top k x
    held / published of a token's, on average) and the shared one."""
    d, la = cb["hidden_size"], cb["linear_attn_config"]
    w = la["num_heads"] * la["head_dim"]
    kda = 4 * d * w + 2 * (d * la["head_dim"] + la["head_dim"] * w) + d * la["num_heads"] + (
        la["short_conv_kernel_size"] * 3 * w)
    h, nope, rope, vd, r = (cb["num_attention_heads"], cb["qk_nope_head_dim"],
                            cb["qk_rope_head_dim"], cb["v_head_dim"], cb["kv_lora_rank"])
    mla = d * h * (nope + rope) + d * (r + rope) + r * h * (nope + vd) + h * vd * d
    n_kda, n_mla = _kinds(cb)
    dense = cb["first_k_dense_replace"]
    moe = cb["num_hidden_layers"] - dense
    f, e = cb["moe_intermediate_size"], cb["published_num_experts"]
    routed = cb["num_experts_per_token"] * 3 * d * f * cb["num_experts"] // e
    moe_ffn = d * e + routed + 3 * d * f * cb["num_shared_experts"]
    return n_kda * kda + n_mla * mla + dense * 3 * d * cb["intermediate_size"] + moe * moe_ffn


def t3_flops(t3: dict, context: int, tokens: int) -> float:
    """A request's T3 FLOPs, as lib/work.py counts Llama_520M's: the prefill
    of `context` positions and `tokens` decode steps on both CFG rows; two
    FLOPs a multiply-add over the active parameters, the MLA layers'
    attention over the positions before in the published form (q.k over
    nope + rope, p.v over v a head), the KDA layers' recurrence (seven
    operations a state element a head), and the speech head."""
    cb = t3["backbone"]
    la = cb["linear_attn_config"]
    n_kda, n_mla = _kinds(cb)
    per_pos = (2 * active_params(cb)
               + n_kda * 7 * la["num_heads"] * la["head_dim"] * la["head_dim"])
    att = lambda ctx: (2 * n_mla * cb["num_attention_heads"]
                       * (cb["qk_nope_head_dim"] + cb["qk_rope_head_dim"] + cb["v_head_dim"]) * ctx)
    head = 2 * cb["hidden_size"] * t3["speech_tokens_dict_size"]
    prefill = context * per_pos + sum(att(i + 1) for i in range(context)) + head
    decode = sum(per_pos + att(context + i + 1) + head for i in range(tokens))
    return 2 * (prefill + decode)
