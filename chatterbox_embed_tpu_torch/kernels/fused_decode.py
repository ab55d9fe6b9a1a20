"""The whole T3 token step (every Llama layer and the final norm) in one
kernel launch: the Hopper port of the Pallas TPU kernel
`chatterbox_embed_tpu/kernels/fused_decode.py:fused_decode_step` (K4).

`stack_for_fused` restacks the backbone's weights into one "wall" per
layer, `plan` says whether a config can take the fused step at all, and
`fused_decode_step` runs one decode step for B rows at one position: on a
CUDA tensor it launches the persistent cooperative kernel in
`csrc/fused_decode.cu` (design notes there), on a CPU tensor it runs
`fused_decode_step_reference`, the plain PyTorch version computed from the
same wall with the same roundings. A CUDA call the kernel cannot take
raises. Each layer's new k/v row is written into the caches in place, at
`cache_pos` (the JAX package returns new caches and inserts outside its
kernel; the values are the same). `start` may be a one-element int32
tensor on the device, read by the kernel, so that a CUDA graph replays one
launch for every text length of a bucket (streaming.py).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..config import LlamaConfig
from ..models.llama import inv_freq
from . import _build
from .flash_decode import decode_attention_reference, device_start, kept_workspace, stream_key

SOURCE = _build.CSRC / "fused_decode.cu"
HEAD_DIM = 64             # the kernel's compiled head width
MAX_ROWS = 16             # the kernel's widest row template
MAX_SPLITS = 8            # the kernel's walk splits a (row, head), at most (kMaxSplits)
# dynamic shared memory a block may use on sm_90 (227 KB), less the kernel's
# fixed reduction scratch (under 6 KB at 16 rows and 512 threads)
SMEM_LIMIT = 227 * 1024 - 8192
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 11 + [ctypes.c_float]
             + [ctypes.c_void_p] * 2)


def plan(cfg: LlamaConfig, b: int):
    """Static geometry of the fused step for `b` rows, or None when the
    config cannot take it (the JAX package's gate, decided before any
    launch): the attention output must be as wide as the hidden state
    (qo == d) and every head its own kv head. The TPU's 128-lane rule
    (B * qo % 128) is a VMEM tiling constraint and is dropped; the wall
    segments need no block size here."""
    d = cfg.hidden_size
    qo = cfg.num_heads * cfg.head_dim
    inter = cfg.intermediate_size
    if qo != d or cfg.num_kv_heads != cfg.num_heads or b < 1:
        return None
    seg = (3 * qo, d, 2 * inter, inter)
    return dict(d=d, qo=qo, inter=inter, h=cfg.num_heads, hd=cfg.head_dim, s_total=sum(seg),
                offsets=(0, seg[0], seg[0] + seg[1], seg[0] + seg[1] + seg[2]))


@torch.no_grad()
def stack_for_fused(llama_params, cfg: LlamaConfig, dtype=torch.bfloat16):
    """Restack the per-layer weights into the kernel's layout:
      wall  (L, S, d) in `dtype`, S = 3*qo + d + 2*I + I, rows per layer
            [q^T | k^T | v^T (3*qo) | o^T (d) | gate^T | up^T (2*I) | down];
      ln1, ln2 (L, d) and fnorm (1, d) fp32.
    Every segment holds one output column per row of d inputs, as in the JAX
    package. `down` differs: the JAX wall stores it natural (I, d); here it is
    stored TRANSPOSED, (d, I) laid out flat over the segment's I rows, so
    that output column n of down is one contiguous I-long read (the kernel
    gives each output column to one warp)."""
    walls, ln1s, ln2s = [], [], []
    for lp in llama_params["layers"]:
        down_t = lp["down"]["w"].t().reshape(-1, cfg.hidden_size)      # (I, d) rows
        rows = [lp["q"]["w"].t(), lp["k"]["w"].t(), lp["v"]["w"].t(), lp["o"]["w"].t(),
                lp["gate"]["w"].t(), lp["up"]["w"].t(), down_t]
        walls.append(torch.cat([r.to(dtype) for r in rows], dim=0))
        ln1s.append(lp["ln1"]["scale"].float())
        ln2s.append(lp["ln2"]["scale"].float())
    return {"wall": torch.stack(walls).contiguous(),
            "ln1": torch.stack(ln1s).contiguous(), "ln2": torch.stack(ln2s).contiguous(),
            "fnorm": llama_params["norm"]["scale"].float()[None, :].contiguous()}


def _rms(h, scale, eps):
    """RMSNorm in fp32, cast to h's dtype (fused_decode.py:164-168)."""
    hf = h.float()
    var = hf.square().mean(dim=-1, keepdim=True)
    return (hf * torch.rsqrt(var + eps) * scale).to(h.dtype)


def _mv(a, rows):
    """a (B, K) in the compute dtype times each wall row (N, K): the fp32
    product (B, N), as the kernel's fp32 accumulation of exact products."""
    return torch.matmul(a.float(), rows.float().t())


def _rope_table(cfg: LlamaConfig, rope_pos, device):
    """cos, sin (hd,) fp32 at RoPE position `rope_pos` (an int or a
    one-element tensor), HF half-split."""
    inv = inv_freq(cfg, device)
    if torch.is_tensor(rope_pos):
        ang = rope_pos.to(device=device, dtype=torch.float32).reshape(()) * inv
    else:
        ang = torch.tensor(float(rope_pos), dtype=torch.float32, device=device) * inv
    ang = torch.cat([ang, ang])
    return torch.cos(ang), torch.sin(ang)


@torch.no_grad()
def fused_decode_step_reference(fused, x, cache_k, cache_v, cache_pos, start,
                                cfg: LlamaConfig, dtype=torch.bfloat16):
    """Plain PyTorch version of the fused step, from the same wall and with
    the kernel's roundings (the JAX kernel's, fused_decode.py:_kernel):
    RMSNorm in fp32 cast to `dtype`; every matvec an fp32 sum of products;
    q, k rounded to `dtype`, RoPE'd at cache_pos - start for every row,
    rounded again; attention over cache slots [start, cache_pos - 1] plus
    the current row (the deferred-insert plain version), rounded; the
    residual added in `dtype` after the fp32 product is rounded; SiLU in
    fp32. x (B, d); cache_k/v (L, Lc, B, H, D). Writes each layer's k/v row
    at cache_pos in place and returns (h (B, d) after the final norm,
    cache_k, cache_v)."""
    b, d = x.shape
    p = plan(cfg, b)
    if p is None:
        raise ValueError("fused_decode_step: the config cannot take the fused step")
    qo, inter, hh, hd = p["qo"], p["inter"], p["h"], p["hd"]
    o_off, gu_off, dn_off = p["offsets"][1:]
    pos = int(cache_pos)
    st = start.clamp_min(0) if torch.is_tensor(start) else int(start)
    eps = cfg.rms_norm_eps
    cos, sin = _rope_table(cfg, pos - st, x.device)
    half = hd // 2

    def rope(t):                                    # (B, qo) dtype
        t = t.reshape(b, hh, hd)
        rot = torch.cat([-t[..., half:], t[..., :half]], dim=-1)
        return (t.float() * cos + rot.float() * sin).to(t.dtype)

    h = x.to(dtype)
    wall = fused["wall"]
    for i in range(wall.shape[0]):
        w = wall[i]
        qkv = _mv(_rms(h, fused["ln1"][i], eps), w[:3 * qo]).to(dtype)
        q = rope(qkv[:, :qo])
        k = rope(qkv[:, qo:2 * qo])
        v = qkv[:, 2 * qo:].reshape(b, hh, hd)
        cache_k[i, pos] = k.to(cache_k.dtype)
        cache_v[i, pos] = v.to(cache_v.dtype)
        att = decode_attention_reference(q, cache_k, cache_v, pos, st, layer=i,
                                         k_cur=k.to(cache_k.dtype),
                                         v_cur=v.to(cache_v.dtype)).to(dtype)
        h = h + _mv(att.reshape(b, qo), w[o_off:o_off + d]).to(dtype)
        gu = _mv(_rms(h, fused["ln2"][i], eps), w[gu_off:gu_off + 2 * inter])
        mm = (F.silu(gu[:, :inter]) * gu[:, inter:]).to(dtype)
        h = h + _mv(mm, w[dn_off:].reshape(d, inter)).to(dtype)
    return _rms(h, fused["fnorm"], eps), cache_k, cache_v


def _library():
    return _build.load(SOURCE, "cbx_fused_decode", _ARGTYPES)


_WORKSPACE: dict = {}


def _workspace(device, b: int, p: dict):
    """The kernel's fp32 scratch for b rows of plan `p`, made once per
    (device, stream, shape): h (B, d), qkv (B, 3 qo), att (B, qo), mm (B, I)
    and the walk's partials (B*H*MAX_SPLITS*(D + 2)); and B*H int32 arrival
    counters, which the kernel sets to 0 itself."""
    sizes = (b * p["d"], b * 3 * p["qo"], b * p["qo"], b * p["inter"],
             b * p["h"] * MAX_SPLITS * (HEAD_DIM + 2))

    def make():
        flat = torch.empty(sum(sizes), dtype=torch.float32, device=device)
        return flat.split(sizes), torch.zeros(b * p["h"], dtype=torch.int32, device=device)

    return kept_workspace(_WORKSPACE, ("fused_decode", str(device), stream_key(device), b,
                                       p["d"], p["qo"], p["inter"], p["h"]), make)


def _check(fused, x, cache_k, cache_v, p, dtype):
    if x.device.type != "cuda":
        raise ValueError(f"fused_decode_step: unsupported device {x.device}")
    if x.dtype != dtype or dtype not in _DTYPE_CODE:
        raise ValueError(f"fused_decode_step: x dtype {x.dtype}, compute dtype {dtype}; "
                         f"the kernel takes float32 or bfloat16, both the same")
    named = [("wall", fused["wall"], dtype), ("cache_k", cache_k, dtype),
             ("cache_v", cache_v, dtype), ("ln1", fused["ln1"], torch.float32),
             ("ln2", fused["ln2"], torch.float32), ("fnorm", fused["fnorm"], torch.float32)]
    for name, t, want in [("x", x, dtype)] + named:
        if t.device != x.device or t.dtype != want or not t.is_contiguous():
            raise ValueError(f"fused_decode_step: {name} must be a contiguous {want} "
                             f"tensor on {x.device} (got {t.dtype} on {t.device})")
    n_layers = fused["wall"].shape[0]
    b, d = x.shape
    if fused["wall"].shape != (n_layers, p["s_total"], d):
        raise ValueError(f"fused_decode_step: wall {tuple(fused['wall'].shape)}, want "
                         f"({n_layers}, {p['s_total']}, {d})")
    want = (n_layers, cache_k.shape[1], b, p["h"], p["hd"])
    if cache_k.shape != want or cache_v.shape != want:
        raise ValueError(f"fused_decode_step: caches {tuple(cache_k.shape)}, want {want}")
    if p["hd"] != HEAD_DIM:
        raise ValueError(f"fused_decode_step: head dim {p['hd']} != {HEAD_DIM}")
    vec = 16 // x.element_size()
    if d % vec or p["inter"] % vec:
        raise ValueError(f"fused_decode_step: d and I must be multiples of {vec}")
    if b > MAX_ROWS:
        raise ValueError(f"fused_decode_step: {b} rows > the kernel's {MAX_ROWS}")
    rows_t = _row_template(b)
    smem = rows_t * max(d, p["inter"]) * x.element_size()
    if smem > SMEM_LIMIT:
        raise ValueError(f"fused_decode_step: {rows_t} rows x {max(d, p['inter'])} "
                         f"{dtype} need {smem} bytes of shared memory > {SMEM_LIMIT}")


def _row_template(b: int) -> int:
    """The kernel's compiled row count for b rows: the next of 2, 4, 8, 16."""
    r = 2
    while r < b:
        r *= 2
    return r


@torch.no_grad()
def fused_decode_step(fused, x, cache_k, cache_v, cache_pos, start,
                      cfg: LlamaConfig, dtype=torch.bfloat16):
    """One token step for B rows at position cache_pos: x (B, d) input
    embeddings; cache_k/v (L, Lc, B, H, D) sequence-major, updated in place
    at cache_pos; `fused` from stack_for_fused in `dtype`. Attends slots
    [start, cache_pos - 1] plus the current row, with RoPE at
    cache_pos - start for every row (so unragged rows only: the caller
    gates). start: an int, or a one-element int32 tensor on x's device,
    which the kernel reads (not checked on the host; a negative one is
    taken as 0). Returns (h (B, d) after the final norm, cache_k, cache_v).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (one launch, counted in `fused_decode_step.launches`) or raise."""
    b = x.shape[0]
    p = plan(cfg, b)
    if p is None:
        raise ValueError("fused_decode_step: the config cannot take the fused step")
    if x.device.type == "cpu":
        return fused_decode_step_reference(fused, x, cache_k, cache_v, cache_pos, start,
                                           cfg, dtype)
    _check(fused, x, cache_k, cache_v, p, dtype)
    start_dev = device_start(start, x, "fused_decode_step") if torch.is_tensor(start) else None
    pos, st = int(cache_pos), 0 if start_dev is not None else int(start)
    n_layers, lcache = cache_k.shape[0], cache_k.shape[1]
    if not 0 <= st <= pos < lcache:
        raise ValueError(f"fused_decode_step: need 0 <= start ({st}) <= cache_pos "
                         f"({pos}) < Lc ({lcache})")
    d, inter = p["d"], p["inter"]
    lib = _library()
    (h_res, qkv, att, mm, part), counters = _workspace(x.device, b, p)
    h_out = torch.empty((b, d), dtype=dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.cbx_fused_decode(
        fused["wall"].data_ptr(), fused["ln1"].data_ptr(), fused["ln2"].data_ptr(),
        fused["fnorm"].data_ptr(), inv_freq(cfg, x.device).data_ptr(), x.data_ptr(),
        cache_k.data_ptr(), cache_v.data_ptr(), h_out.data_ptr(), h_res.data_ptr(),
        qkv.data_ptr(), att.data_ptr(), mm.data_ptr(), part.data_ptr(), counters.data_ptr(),
        n_layers, b, _row_template(b), d, p["h"], p["hd"], inter, lcache, pos, st,
        _DTYPE_CODE[dtype], float(cfg.rms_norm_eps), stream, start_dev)
    if rc != 0:
        raise RuntimeError(f"fused_decode kernel launch failed: cudaError {rc}")
    fused_decode_step.launches += 1
    return h_out, cache_k, cache_v


fused_decode_step.launches = 0
