"""The yardstick's arithmetic: the card's peaks, what a kernel call has to
move and compute, and the model FLOPs of served work, all from shapes.

A kernel's bound is the larger of its bytes over the memory bandwidth and
its operations over the peak of its type, counting each input byte read
once and each output byte written once, and only the keys a call has to
attend (live slots and rows, valid keys). It is reckoned the same whatever
implements the kernel.
"""
from __future__ import annotations

import math

PEAK_OPS = {"bf16": 989e12, "fp32": 67e12}   # NVIDIA H100 SXM, dense
HBM_BYTES_PER_S = 3.35e12


def bound_s(nbytes: float, ops: float, peak: str = "bf16") -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[peak])


def decode_attention_work(spans, holes, heads: int, head_dim: int, itemsize: int = 2):
    """(bytes, operations) of one K1 call: rows attend [lo, hi] minus
    their hole [h0, h1); q and out one row each; a multiply-add for q.k
    and for p.v per live key element. spans, holes: [(a, b)] a row."""
    keys = 0
    for (lo, hi), (h0, h1) in zip(spans, holes):
        n = max(0, hi - lo + 1)
        n -= max(0, min(h1, hi + 1) - max(h0, lo))
        keys += n
    b = len(spans)
    return itemsize * heads * head_dim * (2 * keys + 2 * b), 4 * keys * heads * head_dim


def flash_attention_work(batch: int, seq: int, heads: int, head_dim: int, valid_keys: int,
                         itemsize: int = 2):
    """(bytes, operations) of one K3 call over (B, T, H, D) q, k, v with
    `valid_keys` valid keys summed over the rows: q, k, v read and out
    written; every query row against each valid key, q.k and p.v."""
    elems = batch * seq * heads * head_dim
    return itemsize * 4 * elems + batch * seq, 4 * heads * head_dim * seq * valid_keys


# ------------------------------------------------------------- model FLOPs

def t3_flops(t3: dict, context: int, tokens: int) -> float:
    """A request's T3 FLOPs: the prefill of `context` positions and
    `tokens` decode steps, both on the conditional and unconditional rows;
    matmuls (2 a multiply-add) and attention over the positions before."""
    ll = t3["llama"]
    d, f, n = ll["hidden_size"], ll["intermediate_size"], ll["num_layers"]
    inner = ll["num_heads"] * ll["head_dim"]
    per_pos = 2 * n * (4 * d * inner + 3 * d * f)
    att = lambda ctx: 4 * n * inner * ctx                  # q.k and p.v over ctx keys
    head = 2 * d * t3["speech_tokens_dict_size"]
    prefill = context * per_pos + sum(att(i + 1) for i in range(context)) + head
    decode = sum(per_pos + att(context + i + 1) + head for i in range(tokens))
    return 2 * (prefill + decode)


def _conformer_flops(enc: dict, positions: int) -> float:
    d, u = enc["output_size"], enc["linear_units"]
    block = lambda t: t * (2 * (5 * d * d + 2 * d * u) + 6 * t * d)
    fl = positions * 2 * d * enc["input_size"] + positions * 2 * d * d * 7
    fl += enc["num_blocks"] * block(positions)
    t2 = positions * enc["upsample_stride"]
    fl += t2 * 2 * d * d * 5 + t2 * 2 * d * enc["input_size"]
    return fl + enc["num_up_blocks"] * block(t2)


def _estimator_flops(dec: dict, frames: int) -> float:
    c, inner = dec["channels"], dec["num_heads"] * dec["attention_head_dim"]
    tblocks = dec["n_blocks"] * frames * (2 * (4 * c * inner + 8 * c * c) + 4 * frames * inner)
    resnet = lambda cin: frames * 2 * (3 * cin * c + 3 * c * c + cin * c)
    fl = resnet(dec["in_channels"]) + tblocks                          # down
    fl += frames * 2 * 3 * c * c                                        # downsample
    fl += dec["num_mid_blocks"] * (resnet(c) + tblocks)                 # mid
    fl += resnet(2 * c) + tblocks                                       # up
    fl += frames * 2 * (3 * c * c + 3 * c * c + c * dec["out_channels"])   # upsample, final
    return fl


def _hift_flops(h: dict, frames: int) -> float:
    base, n_in = h["base_channels"], h["in_channels"]
    f0c = h["f0_cond_channels"]
    fl = frames * 2 * (3 * n_in * f0c + 4 * 3 * f0c * f0c + f0c)       # f0 predictor
    fl += frames * 2 * 7 * n_in * base                                  # conv_pre
    rate, ch = frames, base
    nfft2 = h["istft_n_fft"] + 2
    rates = list(h["upsample_rates"])
    down = [1] + rates[::-1][:-1]
    down_cum = [int(math.prod(down[: len(down) - i])) for i in range(len(down))]
    for i, (u, k) in enumerate(zip(rates, h["upsample_kernel_sizes"])):
        out = ch // 2
        fl += rate * 2 * ch * out * k                                   # transposed conv
        rate *= u
        ks = h["resblock_kernel_sizes"]
        for kk, dil in zip(ks, h["resblock_dilation_sizes"]):
            fl += rate * 2 * 2 * len(dil) * kk * out * out
        sk, sd = h["source_resblock_kernel_sizes"][i], h["source_resblock_dilation_sizes"][i]
        width = 1 if down_cum[i] == 1 else 2 * down_cum[i]
        fl += rate * 2 * (2 * len(sd) * sk * out * out + width * nfft2 * out)
        ch = out
    return fl + rate * 2 * 7 * ch * nfft2


def s3gen_flops(s3: dict, prompt_tokens: int, tokens: int) -> float:
    """One row's S3Gen FLOPs: the conformer over prompt + tokens, the
    estimator at every Euler step on the CFG pair over their mel frames,
    and HiFT over the generated frames."""
    fl = s3["flow"]
    r = fl["token_mel_ratio"]
    frames = r * (prompt_tokens + tokens)
    out = _conformer_flops(fl["encoder"], prompt_tokens + tokens)
    out += fl["cfm"]["n_timesteps"] * 2 * _estimator_flops(fl["decoder"], frames)
    return out + _hift_flops(s3["hift"], r * tokens)


def s3tokenizer_flops(tok: dict, tokens: int) -> float:
    """The S3 tokenizer's FLOPs on a source of `tokens` tokens (4 mel
    frames a token)."""
    d, m = tok["n_state"], tok["n_mels"]
    t1, t = 2 * tokens, tokens
    fl = t1 * 2 * 3 * m * d + t * 2 * 3 * d * d
    block = t * (2 * (4 * d * d + 8 * d * d + tok["fsmn_kernel"] * d) + 4 * t * d)
    return fl + tok["n_layers"] * block + t * 2 * d * tok["fsq_dim"]
