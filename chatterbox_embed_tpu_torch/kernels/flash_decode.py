"""Flash-decode attention for the T3 decode step: the Hopper port of the
Pallas TPU kernel `chatterbox_embed_tpu/kernels/flash_decode.py`, both of its
entries.

`decode_attention` attends one query token per (row, head) to the live
cache slots [start, cache_pos] of one layer's sequence-major cache, minus an
optional per-row dead range [lo, hi) (K1). Its second entry (K1s, the
deferred insert) takes the whole stacked cache (nL, Lc, B, H, D) with a
`layer` index and the current token's `k_cur`/`v_cur`: the walk then covers
[start, cache_pos - 1] and the current row finishes the softmax, so the
caller writes every layer's row in one stacked insert after the layer loop.
K1 also takes an optional per-row `span` (B, 2): row b then attends
[span[b, 0], span[b, 1]] minus its hole in place of the shared [start,
cache_pos] (the continuous engine's slots, models/t3_engine.py:
engine_spans); an empty span gives 0. `start` may be a one-element int32
tensor on the device, read by the kernel: a CUDA graph of the stream's
first chunk (streaming.py) then replays one launch for every text length
of a bucket.
Both take an int8 cache (the int8 KV cache, CHATTERBOX_INT8_KV=1) with its
fp32 scale planes `k_scale`, `v_scale`, one scale a (slot, row, head): the
int8 entry (a kernel of its own in the same source) walks the int8 slabs
and multiplies each score by its key's scale and each probability by its
value's (the JAX package's mode-1 formula, models/llama.py:418-440, which
it runs in XLA).
q, k_cur, v_cur and the output keep the compute dtype.
On a CUDA tensor it launches the hand-written split-KV kernel in
`csrc/flash_decode.cu` (design notes there), one launch a call, with a
scratch workspace kept per (device, stream, dtype, B, H, Lc), or made for
one CUDA graph capture alone (`graph_workspaces`); on a CPU tensor it
runs `decode_attention_reference`, the plain PyTorch version. There is no
other path: a CUDA call that the kernel cannot take raises.
`walk_reference` walks the kernel's schedule in plain PyTorch for the tests.

The kernel is compiled with `nvcc` for sm_90a into a shared library with a
plain C entry, loaded with ctypes, the first time a CUDA tensor arrives
(`kernels/_build.py`, the build route of every kernel of the port).
"""
from __future__ import annotations

import contextlib
import ctypes
import math

import torch

from . import _build

SOURCE = _build.CSRC / "flash_decode.cu"
HEAD_DIM = 64          # the kernel's compiled head width
# The split-KV launch (csrc/decode_walk.cuh and csrc/flash_decode.cu; kept
# equal by tests/test_torch_decode_walk.py): a grid (B*H, S) of
# SPLIT_WARPS-warp blocks, S = splits_for(B*H, Lc). A warp-wide load brings
# GROUPS keys (8 lanes a 64-wide row) and a warp scores LOADS[dtype] of them
# a tile. An int8 cache is staged through shared memory in tiles of
# INT8_TILE keys, INT8_STAGES tiles in a ring, the kernel compiled for
# INT8_BLOCKS resident blocks an SM.
SPLIT_WARPS = 4
SPLIT_BLOCKS = 512     # B*H*S the split count aims at: ~4 blocks on each of 132 SMs
MIN_SPLIT_KEYS = 32    # slots a split covers at least, at full capacity
GROUPS = 4
INT8_TILE = 64
INT8_STAGES = 2
INT8_BLOCKS = 4
LOADS = {torch.bfloat16: 8, torch.float32: 4,                   # by the cache's dtype
         torch.int8: INT8_TILE // (SPLIT_WARPS * GROUPS)}
_SCALE_LOG2 = 0.125 * math.log2(math.e)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 9 + [ctypes.c_void_p] * 2)
_INFO_ARGTYPES = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]


def splits_for(bh: int, lcache: int) -> int:
    """The kernels' split count for B*H (row, head)s and cache capacity Lc:
    SPLIT_BLOCKS / (B*H) rounded up, at most Lc / MIN_SPLIT_KEYS, at least 1."""
    want = -(-SPLIT_BLOCKS // bh)
    cap = -(-lcache // MIN_SPLIT_KEYS)
    return max(1, min(want, cap))


def split_range(start: int, walk_end: int, n_splits: int, split: int):
    """Split `split`'s slots [lo, hi] of the live range [start, walk_end]
    (empty when lo > hi): ceil(live / S) slots each, from the start."""
    live = walk_end - start + 1
    per = -(-live // n_splits) if live > 0 else 0
    lo = start + split * per
    return lo, min(walk_end, lo + per - 1)


_WORKSPACE: dict = {}
# the workspaces of the CUDA graph captures in progress, innermost last
_CAPTURES: list = []


@contextlib.contextmanager
def graph_workspaces():
    """Inside the block every kernel workspace (K1/K1s here, K4's in
    fused_decode.py) is made for one CUDA graph capture alone: in the
    graph's memory pool, held in the dict this yields (the caller keeps it
    with the graph), and never taken from or left in the shared caches,
    whose workspaces eager calls use (an eager call on another stream could
    otherwise run beside a replay on the same scratch)."""
    own: dict = {}
    _CAPTURES.append(own)
    try:
        yield own
    finally:
        _CAPTURES.pop()


def kept_workspace(shared: dict, key, make):
    """The workspace `key` of `shared` (made by `make` the first time), or
    of the capture in progress (`graph_workspaces`)."""
    store = _CAPTURES[-1] if _CAPTURES else shared
    ws = store.get(key)
    if ws is None:
        ws = store[key] = make()
    return ws


def stream_key(device) -> int:
    """The current stream of `device` (0 off the card): launches on two
    streams may overlap, so each stream gets its own workspace."""
    device = torch.device(device)
    return torch.cuda.current_stream(device).cuda_stream if device.type == "cuda" else 0


def workspace(device, dtype, b: int, h: int, lcache: int):
    """The kernels' scratch for one (device, stream, dtype, B, H, Lc), made
    once: the partials (m, l: B*H*S each, then acc: B*H*S*64, fp32) and one
    arrival counter a (row, head), zero, which every launch leaves zero."""
    n = b * h * splits_for(b * h, lcache)
    return kept_workspace(
        _WORKSPACE, ("flash_decode", str(device), stream_key(device), dtype, b, h, lcache),
        lambda: (torch.empty(n * (HEAD_DIM + 2), dtype=torch.float32, device=device),
                 torch.zeros(b * h, dtype=torch.int32, device=device)))


def _layer_slab(k, v, layer, k_scale=None, v_scale=None):
    """One layer's (Lc, B, H, D) view of a per-layer or stacked cache, and
    its (Lc, B, H) scale planes (None for a float cache)."""
    if k.dim() == 5:
        if layer is None:
            raise ValueError("decode_attention: a stacked (nL, Lc, B, H, D) cache needs `layer`")
        k, v = k[layer], v[layer]
        if k_scale is not None:
            k_scale, v_scale = k_scale[layer], v_scale[layer]
    return k, v, k_scale, v_scale


def _row_ranges(b, cache_pos, start, span, deferred, device):
    """Each row's walk [lo, hi] as (B,) long tensors: the shared [start,
    cache_pos] (cache_pos - 1 with the deferred entry), or the rows' span."""
    if span is not None:
        span = torch.as_tensor(span, dtype=torch.long, device=device)
        return span[:, 0], span[:, 1]
    last = cache_pos - 1 if deferred else cache_pos
    lo = (start.to(device=device, dtype=torch.long).reshape(1).clamp_min(0).expand(b)
          if torch.is_tensor(start) else torch.full((b,), start, dtype=torch.long, device=device))
    return lo, torch.full((b,), last, dtype=torch.long, device=device)


def decode_attention_reference(q, k, v, cache_pos, start=0, hole=None, layer=None,
                               k_cur=None, v_cur=None, span=None, k_scale=None, v_scale=None):
    """Plain PyTorch version (mirrors the JAX package's
    decode_attention_reference, and its kernel's deferred-insert entry).
    q (B, H, D); k, v (Lc, B, H, D), or (nL, Lc, B, H, D) with `layer`;
    hole (B, 2) int or None. With k_cur/v_cur (B, H, D) the cache slots
    [start, cache_pos - 1] attend and the current row is one more
    logit/value column. span (B, 2) int or None: row b attends [span[b, 0],
    span[b, 1]] in place of [start, cache_pos], and a row whose span holds
    no live key gives 0 (the kernel's value; without a span such a row is
    NaN, as in the JAX package). With k_scale/v_scale ((Lc, B, H), or
    (nL, Lc, B, H), fp32) k and v are an int8 cache, read by the JAX
    package's mode-1 formula (its XLA decode, models/llama.py:418-440): the
    logits (q . kq) * ks / sqrt(D), then (w * vs) rounded to q's dtype times
    vq, summed and rounded to q's dtype before the current row's fp32 term
    (k_cur/v_cur stay unquantised). Returns (B, H, D) in q's dtype."""
    k, v, k_scale, v_scale = _layer_slab(k, v, layer, k_scale, v_scale)
    lcache = k.shape[0]
    lo, hi = _row_ranges(q.shape[0], cache_pos, start, span, k_cur is not None, q.device)
    idx = torch.arange(lcache, device=q.device)
    mask = (idx[None, :] >= lo[:, None]) & (idx[None, :] <= hi[:, None])
    if hole is not None:
        hole = torch.as_tensor(hole, dtype=torch.int32, device=q.device)
        mask = mask & ~((idx[None, :] >= hole[:, :1]) & (idx[None, :] < hole[:, 1:2]))
    mask = mask[:, None, :]
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bhd,kbhd->bhk", q.float(), k.float())
    if k_scale is not None:
        logits = logits * k_scale.permute(1, 2, 0)
    logits = (logits * scale).masked_fill(~mask, float("-inf"))
    vals = v.float()
    if k_cur is not None:
        cur = (q.float() * k_cur.float()).sum(-1, keepdim=True) * scale     # (B, H, 1)
        logits = torch.cat([logits, cur], dim=-1)
        if k_scale is None:
            vals = torch.cat([vals, v_cur.float()[None]], dim=0)
    w = torch.softmax(logits, dim=-1)
    if span is not None:
        w = torch.where(mask.any(-1, keepdim=True), w, torch.zeros_like(w))
    if k_scale is None:
        return torch.einsum("bhk,kbhd->bhd", w, vals).to(q.dtype)
    wl = (w[..., :lcache] * v_scale.permute(1, 2, 0)).to(q.dtype)
    att = torch.einsum("bhk,kbhd->bhd", wl.float(), vals).to(q.dtype)
    if k_cur is not None:
        att = (att.float() + w[..., lcache:] * v_cur.float()).to(q.dtype)
    return att


def _exp2s(x):
    """exp2(x * scale * log2 e), the kernels' exponent, with exp2(-inf) = 0."""
    return torch.exp2(x * _SCALE_LOG2)


def _merge(m, l, acc, dim):
    """Max-rescale merge of online-softmax states along `dim` (unscaled m);
    a state with l = 0 adds nothing, and all-empty gives m = -inf, l = 0."""
    mb = m.amax(dim=dim)
    f = torch.where(l > 0, _exp2s(m - mb.unsqueeze(dim)), torch.zeros_like(l))
    return mb, (l * f).sum(dim), (acc * f.unsqueeze(-1)).sum(dim)


@torch.no_grad()
def walk_reference(q, k, v, cache_pos, start=0, hole=None, layer=None, k_cur=None,
                   v_cur=None, span=None, k_scale=None, v_scale=None):
    """The kernels' schedule (csrc/flash_decode.cu over decode_walk.cuh)
    walked in plain PyTorch, fp32, for tests: each row's live range [start,
    walk_end] (or its span, clamped to the cache) cut into splits_for(B*H,
    Lc) splits; in each split, tiles of SPLIT_WARPS * LOADS[q.dtype] *
    GROUPS keys, slot u of warp w's group g holding key base + (u *
    SPLIT_WARPS + w) * GROUPS + g; per warp one max a tile, exp2 with the
    scale folded in, one rescale a tile; the warps merged, then the splits
    by the last block (max-rescale, empty splits adding nothing); K1s's
    current row folded in last. An int8 cache (k_scale, v_scale) walks
    tiles of INT8_TILE keys (LOADS[torch.int8] slots a warp), each score
    times its key's scale and each value term's probability times its
    value's, l unscaled.
    Arguments as decode_attention; returns (B, H, D) in q's dtype. Nothing
    on a serving path calls it."""
    k, v, k_scale, v_scale = _layer_slab(k, v, layer, k_scale, v_scale)
    lcache, b, h, d = k.shape
    bh, w_n = b * h, SPLIT_WARPS
    qf = q.float().reshape(bh, d)
    kf, vf = k.float().reshape(lcache, bh, d), v.float().reshape(lcache, bh, d)
    ks = vs = torch.ones((lcache, bh))
    if k_scale is not None:
        ks, vs = k_scale.float().reshape(lcache, bh), v_scale.float().reshape(lcache, bh)
    lo_r, hi_r = _row_ranges(b, cache_pos, start, None if span is None else
                             torch.as_tensor(span).cpu(), k_cur is not None, "cpu")
    if span is not None:
        lo_r, hi_r = lo_r.clamp_min(0), hi_r.clamp_max(lcache - 1)
    start_bh, end_bh = lo_r.repeat_interleave(h), hi_r.repeat_interleave(h)
    hole_lo = torch.zeros(bh, dtype=torch.long)
    hole_hi = torch.zeros(bh, dtype=torch.long)
    if hole is not None:
        hole = torch.as_tensor(hole, dtype=torch.long).cpu()
        hole_lo, hole_hi = hole[:, 0].repeat_interleave(h), hole[:, 1].repeat_interleave(h)
    n_splits = splits_for(bh, lcache)
    tile = w_n * LOADS[k.dtype] * GROUPS
    slot = torch.arange(tile).reshape(LOADS[k.dtype], w_n, GROUPS).transpose(0, 1)
    slot = slot.reshape(w_n, -1)                        # (warp, its keys in a tile)
    live_n = (end_bh - start_bh + 1).clamp_min(0)
    per = -(-live_n // n_splits)                        # (BH,) slots a split
    rows = torch.arange(bh)[:, None, None]
    parts = []
    for s in range(n_splits):
        lo = start_bh + s * per
        hi = torch.minimum(end_bh, lo + per - 1)
        m = torch.full((bh, w_n), -math.inf)
        l = torch.zeros(bh, w_n)
        acc = torch.zeros(bh, w_n, d)
        n_tiles = int(((hi - lo + 1).clamp_min(0) + tile - 1).div(tile, rounding_mode="floor")
                      .max()) if bh else 0
        for t in range(n_tiles):
            j = lo[:, None, None] + t * tile + slot[None]                  # (BH, W, K)
            live = (j <= hi[:, None, None]) & ((j < hole_lo[:, None, None])
                                               | (j >= hole_hi[:, None, None]))
            jc = j.clamp(0, lcache - 1)
            sc = (torch.einsum("bd,bwkd->bwk", qf, kf[jc, rows]) * ks[jc, rows]
                  ).masked_fill(~live, -math.inf)
            m_new = torch.maximum(m, sc.amax(-1))
            keep = m_new == -math.inf                       # nothing live yet: no change
            alpha = torch.where(keep, torch.ones_like(m), _exp2s(m - m_new))
            p = torch.where(keep[..., None], torch.zeros_like(sc),
                            _exp2s(sc - m_new[..., None]))
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum("bwk,bwkd->bwd", p * vs[jc, rows],
                                                        vf[jc, rows])
            m = torch.where(keep, m, m_new)
        parts.append(_merge(m, l, acc, 1))                 # the block's warps
    mb, lb, ab = _merge(*(torch.stack(x, 1) for x in zip(*parts)), 1)   # the last block
    if k_cur is not None:
        s_cur = (qf * k_cur.float().reshape(bh, d)).sum(-1)
        m_new = torch.maximum(mb, s_cur)
        alpha, p = _exp2s(mb - m_new), _exp2s(s_cur - m_new)
        lb = lb * alpha + p
        ab = ab * alpha[:, None] + p[:, None] * v_cur.float().reshape(bh, d)
    out = torch.where(lb[:, None] > 0, ab / lb.clamp_min(1e-30)[:, None], torch.zeros_like(ab))
    return out.reshape(b, h, d).to(q.dtype)


def _library():
    return _build.load(SOURCE, "cbx_flash_decode", _ARGTYPES)


def kernel_info(dtype, int8: bool = False) -> dict:
    """What the CUDA runtime reports of the kernel instance for q's `dtype`
    on a float / bf16 cache or (int8) an int8 one, in the library that
    launches it: registers and local (spill) bytes a thread, resident
    blocks an SM, static shared bytes a block. Needs the card."""
    fn = _library().cbx_flash_decode_info
    fn.restype, fn.argtypes = ctypes.c_int, _INFO_ARGTYPES
    info = (ctypes.c_int * 4)()
    rc = fn(_DTYPE_CODE[dtype], int(int8), info)
    if rc != 0:
        raise RuntimeError(f"cbx_flash_decode_info: cudaError {rc}")
    return dict(zip(("registers", "local_bytes", "blocks_per_sm", "smem_bytes"), info))


def _check_rows(name, t, q):
    if (t.device != q.device or t.dtype != torch.int32 or t.shape != (q.shape[0], 2)
            or not t.is_contiguous()):
        raise ValueError(f"decode_attention: {name} must be a contiguous "
                         "(B, 2) int32 tensor on q's device")


def _check(q, k, v, hole, k_cur, v_cur, span, k_scale, v_scale):
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    int8 = k_scale is not None
    cache_dtype = torch.int8 if int8 else q.dtype
    pairs = [("k", k, cache_dtype), ("v", v, cache_dtype)]
    if k_cur is not None:
        pairs += [("k_cur", k_cur, q.dtype), ("v_cur", v_cur, q.dtype)]
    if int8:
        pairs += [("k_scale", k_scale, torch.float32), ("v_scale", v_scale, torch.float32)]
    for name, t, dtype in pairs:
        if t.device != q.device:
            raise ValueError(f"decode_attention: {name} on {t.device}, q on {q.device}")
        if t.dtype != dtype:
            raise ValueError(f"decode_attention: {name} dtype {t.dtype}, want {dtype} "
                             f"(q {q.dtype}{', int8 cache' if int8 else ''})")
        if not t.is_contiguous():
            raise ValueError(f"decode_attention: {name} must be contiguous")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("decode_attention: k and v must start on a 16-byte boundary")
    if int8 and (k_scale.shape != k.shape[:-1] or v_scale.shape != k.shape[:-1]):
        raise ValueError(f"decode_attention: k_scale, v_scale must be {tuple(k.shape[:-1])}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"decode_attention: dtype {q.dtype} not supported "
                         f"(float32, bfloat16)")
    if (q.dim() != 3 or k.dim() not in (4, 5) or k.shape != v.shape
            or k.shape[-3:] != q.shape):
        raise ValueError(f"decode_attention: want q (B, H, D) and k, v ([nL,] Lc, B, H, D); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if k_cur is not None and (k_cur.shape != q.shape or v_cur.shape != q.shape):
        raise ValueError(f"decode_attention: k_cur, v_cur must be {tuple(q.shape)}")
    if q.shape[-1] != HEAD_DIM:
        raise ValueError(f"decode_attention: head dim {q.shape[-1]} != {HEAD_DIM}")
    if not q.is_contiguous():
        raise ValueError("decode_attention: q must be contiguous")
    for name, t in (("hole", hole), ("span", span)):
        if t is not None:
            _check_rows(name, t, q)


def device_start(start, x, name: str = "decode_attention") -> int:
    """A tensor `start` as the int32 pointer a kernel reads (K1/K1s here,
    K4 in fused_decode.py), checked to be one element on x's device."""
    if (start.device != x.device or start.dtype != torch.int32 or start.numel() != 1
            or not start.is_contiguous()):
        raise ValueError(f"{name}: a tensor start must be one contiguous int32 element on "
                         "the inputs' device")
    return start.data_ptr()


def decode_attention(q, k, v, cache_pos, start=0, hole=None, layer=None,
                     k_cur=None, v_cur=None, span=None, k_scale=None, v_scale=None):
    """q (B, H, D); k, v (Lc, B, H, D) one layer's cache, or the stacked
    (nL, Lc, B, H, D) cache with `layer`. Attends slots [start, cache_pos]
    minus each row's optional hole [lo, hi) (hole: (B, 2) int32); with
    k_cur/v_cur (B, H, D), slots [start, cache_pos - 1] and then the current
    row (the cache slot cache_pos is not read). With span ((B, 2) int32, K1
    only) row b attends [span[b, 0], span[b, 1]] minus its hole instead, and
    a row with no live key gives 0; the span is read on the device (no
    check of its values on the host: the kernel clamps it to the cache).
    start: an int, or a one-element int32 tensor on q's device, which the
    kernel reads (its value is not checked on the host either: the kernel
    takes a negative one as 0, as a span's, and a start past the walk's end
    walks nothing). k_scale, v_scale ((Lc, B, H), or (nL, Lc, B, H) beside a stacked cache;
    fp32): k and v are an int8 cache with these scales (the int8 entry);
    q, k_cur and v_cur keep their float dtype. Returns (B, H, D) in q's
    dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise. A launch adds one to `decode_attention.launches` (K1) or, with
    k_cur/v_cur, to `decode_attention.launches_deferred` (K1s); with an
    int8 cache to `launches_int8` or `launches_int8_deferred` instead."""
    if (k_cur is None) != (v_cur is None):
        raise ValueError("decode_attention: give both k_cur and v_cur, or neither")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("decode_attention: give both k_scale and v_scale, or neither")
    if (k.dtype == torch.int8) != (k_scale is not None):
        raise ValueError("decode_attention: an int8 cache needs its k_scale and v_scale, "
                         "and only an int8 cache takes them")
    if span is not None and k_cur is not None:
        raise ValueError("decode_attention: a per-row span is K1's; the deferred entry "
                         "takes none")
    if q.device.type == "cpu":
        return decode_attention_reference(q, k, v, cache_pos, start, hole, layer, k_cur,
                                          v_cur, span, k_scale, v_scale)
    _check(q, k, v, hole, k_cur, v_cur, span, k_scale, v_scale)
    start_dev = device_start(start, q) if torch.is_tensor(start) else None
    cache_pos, start = int(cache_pos), 0 if start_dev is not None else int(start)
    n_layers = k.shape[0] if k.dim() == 5 else 1
    layer = 0 if k.dim() == 4 else int(layer)
    lcache = k.shape[-4]
    if not 0 <= start <= cache_pos < lcache:
        raise ValueError(f"decode_attention: need 0 <= start ({start}) <= "
                         f"cache_pos ({cache_pos}) < Lc ({lcache})")
    if not 0 <= layer < n_layers:
        raise ValueError(f"decode_attention: layer {layer} outside [0, {n_layers})")
    b, h, d = q.shape
    lib = _library()
    part, counters = workspace(q.device, q.dtype, b, h, lcache)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    deferred = k_cur is not None
    int8 = k_scale is not None
    rc = lib.cbx_flash_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        k_scale.data_ptr() if int8 else None, v_scale.data_ptr() if int8 else None,
        None if hole is None else hole.data_ptr(),
        None if span is None else span.data_ptr(),
        k_cur.data_ptr() if deferred else None, v_cur.data_ptr() if deferred else None,
        out.data_ptr(), part.data_ptr(), counters.data_ptr(),
        b, h, d, lcache, layer, cache_pos, start, splits_for(b * h, lcache),
        _DTYPE_CODE[q.dtype], stream, start_dev)
    if rc != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: cudaError {rc}")
    counter = ("launches_int8" if int8 else "launches") + ("_deferred" if deferred else "")
    setattr(decode_attention, counter, getattr(decode_attention, counter) + 1)
    return out


decode_attention.launches = 0
decode_attention.launches_deferred = 0
decode_attention.launches_int8 = 0
decode_attention.launches_int8_deferred = 0
