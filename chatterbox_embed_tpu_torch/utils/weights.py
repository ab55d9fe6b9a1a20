"""Checkpoint conversion: reference torch state-dicts -> the port's trees.

The port's own copy of what `ChatterboxTTS.from_local` needs from
`chatterbox_embed_tpu/utils/weights.py`, changed in one respect: the
converters produce the port's parameter layouts directly, with no detour
through the JAX package's layout. So convolution kernels keep the layout
torch stores them in (conv1d (out, in/groups, width), transposed conv
(in, out, width), conv2d (out, in, kh, kw)), and linear weights go from
torch's (out, in) to (in, out), since the port computes x @ w. Weight-norm
parametrizations (HiFT, f0 predictor) are folded into plain kernels, and
batch-norm running stats are kept for the eval-form batch norm.

Pure numpy, the safetensors reader (`load_safetensors`) included. Each
converter takes {name: np.ndarray} and returns the matching
tree of arrays; `weights.from_arrays` checks every leaf's shape against the
port's expected tree and makes the tensors, so a mismatched checkpoint fails
at load time. tests/test_torch_weights.py holds these converters against the
JAX package's converters followed by `weights.from_jax_params`.
"""
from __future__ import annotations

import json
import struct
from typing import Dict

import numpy as np

Array = np.ndarray
StateDict = Dict[str, Array]


# ---------------------------------------------------------------------------
# Conversion coverage validation
# ---------------------------------------------------------------------------

class _TrackedDict(dict):
    """State dict that records key reads, for conversion-coverage checks."""

    def __init__(self, sd: StateDict):
        super().__init__(sd)
        self.read: set = set()

    def __getitem__(self, k):
        self.read.add(k)
        return super().__getitem__(k)


def _convert_validated(convert, sd: StateDict, ignore=()):
    """Run `convert` over `sd` and fail LOUDLY on layout drift.

    - A missing key raises KeyError immediately, annotated with the closest
      checkpoint names so a renamed upstream module is diagnosable.
    - Checkpoint keys the converter never read (minus `ignore` regexes, for
      buffers / train-only params) raise ValueError: silently-dropped weights
      mean the architecture diverges and outputs would be silently wrong.
    """
    import re
    tracked = _TrackedDict(sd)
    try:
        tree = convert(tracked)
    except KeyError as e:
        missing = str(e.args[0])
        stem = missing.split(".")[0]
        near = sorted(k for k in sd if k.startswith(stem))[:10]
        raise KeyError(
            f"checkpoint missing {missing!r}; keys under {stem!r} look like: "
            f"{near}") from None
    pats = [re.compile(p) for p in ignore]
    unused = sorted(k for k in sd if k not in tracked.read
                    and not any(p.fullmatch(k) for p in pats))
    if unused:
        raise ValueError(
            f"{len(unused)} checkpoint tensors were not consumed by the "
            f"converter (architecture drift?): {unused[:20]}"
            + (" ..." if len(unused) > 20 else ""))
    return tree


def _lin(sd: StateDict, prefix: str, bias: bool = True):
    p = {"w": np.ascontiguousarray(sd[prefix + ".weight"].T)}
    if bias and prefix + ".bias" in sd:
        p["b"] = sd[prefix + ".bias"]
    return p


def _conv1d(sd: StateDict, prefix: str):
    """torch (out, in/groups, width), kept."""
    p = {"w": sd[prefix + ".weight"]}
    if prefix + ".bias" in sd:
        p["b"] = sd[prefix + ".bias"]
    return p


def _conv1d_wn(sd: StateDict, prefix: str):
    """Fold weight-norm: w = g * v / ||v|| (per out-channel)."""
    g = sd[prefix + ".parametrizations.weight.original0"]
    v = sd[prefix + ".parametrizations.weight.original1"]
    norm = np.sqrt((v ** 2).sum(axis=(1, 2), keepdims=True))
    w = g * v / norm
    p = {"w": np.ascontiguousarray(w)}
    if prefix + ".bias" in sd:
        p["b"] = sd[prefix + ".bias"]
    return p


def _convt1d_wn(sd: StateDict, prefix: str):
    """ConvTranspose1d weight-norm fold; torch's (in, out, width) is kept.

    weight_norm's default dim=0 is the IN-channel axis for ConvTranspose1d
    (g has shape (in, 1, 1)), so the norm reduces over (out, width).
    """
    g = sd[prefix + ".parametrizations.weight.original0"]
    v = sd[prefix + ".parametrizations.weight.original1"]
    norm = np.sqrt((v ** 2).sum(axis=(1, 2), keepdims=True))
    w = g * v / norm
    p = {"w": np.ascontiguousarray(w)}
    if prefix + ".bias" in sd:
        p["b"] = sd[prefix + ".bias"]
    return p


def _conv2d(sd: StateDict, prefix: str):
    """torch (out, in, kh, kw), kept."""
    p = {"w": sd[prefix + ".weight"]}
    if prefix + ".bias" in sd:
        p["b"] = sd[prefix + ".bias"]
    return p


def _ln(sd: StateDict, prefix: str):
    return {"scale": sd[prefix + ".weight"], "bias": sd[prefix + ".bias"]}


def _bn(sd: StateDict, prefix: str):
    p = {"mean": sd[prefix + ".running_mean"], "var": sd[prefix + ".running_var"]}
    if prefix + ".weight" in sd:
        p["scale"] = sd[prefix + ".weight"]
        p["bias"] = sd[prefix + ".bias"]
    else:  # affine=False
        n = p["mean"].shape[0]
        p["scale"] = np.ones(n, np.float32)
        p["bias"] = np.zeros(n, np.float32)
    return p


def _emb(sd: StateDict, prefix: str):
    return {"w": sd[prefix + ".weight"]}


# ---------------------------------------------------------------------------
# Llama backbone (HF transformers naming, reference t3.py:45-46)
# ---------------------------------------------------------------------------

def convert_llama(sd: StateDict, num_layers: int, prefix: str = "") -> dict:
    layers = []
    for i in range(num_layers):
        lp = f"{prefix}layers.{i}."
        layers.append({
            "ln1": {"scale": sd[lp + "input_layernorm.weight"]},
            "q": _lin(sd, lp + "self_attn.q_proj", bias=False),
            "k": _lin(sd, lp + "self_attn.k_proj", bias=False),
            "v": _lin(sd, lp + "self_attn.v_proj", bias=False),
            "o": _lin(sd, lp + "self_attn.o_proj", bias=False),
            "ln2": {"scale": sd[lp + "post_attention_layernorm.weight"]},
            "gate": _lin(sd, lp + "mlp.gate_proj", bias=False),
            "up": _lin(sd, lp + "mlp.up_proj", bias=False),
            "down": _lin(sd, lp + "mlp.down_proj", bias=False),
        })
    return {"layers": layers, "norm": {"scale": sd[prefix + "norm.weight"]}}


# ---------------------------------------------------------------------------
# VoiceEncoder (reference: models/voice_encoder/voice_encoder.py:119-137)
# ---------------------------------------------------------------------------

def convert_voice_encoder(sd: StateDict, validate: bool = True) -> dict:
    def build(d):
        lstm = []
        for i in range(3):
            lstm.append({
                "wi": np.ascontiguousarray(d[f"lstm.weight_ih_l{i}"].T),
                "wh": np.ascontiguousarray(d[f"lstm.weight_hh_l{i}"].T),
                "bi": d[f"lstm.bias_ih_l{i}"],
                "bh": d[f"lstm.bias_hh_l{i}"],
            })
        return {"lstm": lstm, "proj": _lin(d, "proj")}
    if not validate:
        return build(sd)
    return _convert_validated(build, sd, ignore=VE_IGNORED_KEYS)


# ---------------------------------------------------------------------------
# T3 (reference: models/t3/t3.py:42-66, modules/cond_enc.py, perceiver.py)
# ---------------------------------------------------------------------------

def convert_t3(sd: StateDict, num_layers: int = 30, validate: bool = True) -> dict:
    def build(d):
        perceiver = {
            "query": d["cond_enc.perceiver.pre_attention_query"],
            "norm": _ln(d, "cond_enc.perceiver.attn.norm"),
            "q": _lin(d, "cond_enc.perceiver.attn.to_q"),
            "k": _lin(d, "cond_enc.perceiver.attn.to_k"),
            "v": _lin(d, "cond_enc.perceiver.attn.to_v"),
            "o": _lin(d, "cond_enc.perceiver.attn.proj_out"),
        }
        return {
            "llama": convert_llama(d, num_layers, prefix="tfmr."),
            "text_emb": _emb(d, "text_emb"),
            "speech_emb": _emb(d, "speech_emb"),
            "text_pos_emb": _emb(d, "text_pos_emb.emb"),
            "speech_pos_emb": _emb(d, "speech_pos_emb.emb"),
            "text_head": _lin(d, "text_head", bias=False),
            "speech_head": _lin(d, "speech_head", bias=False),
            "cond_enc": {
                "spkr_enc": _lin(d, "cond_enc.spkr_enc"),
                "emotion_adv_fc": _lin(d, "cond_enc.emotion_adv_fc", bias=False),
                "perceiver": perceiver,
            },
        }
    if not validate:
        return build(sd)
    return _convert_validated(build, sd, ignore=T3_IGNORED_KEYS)


# ---------------------------------------------------------------------------
# S3Gen (reference: models/s3gen/s3gen.py:53-98, 270-287)
# ---------------------------------------------------------------------------

def _conformer_block(sd: StateDict, p: str) -> dict:
    return {
        "norm_mha": _ln(sd, p + "norm_mha"),
        "q": _lin(sd, p + "self_attn.linear_q"),
        "k": _lin(sd, p + "self_attn.linear_k"),
        "v": _lin(sd, p + "self_attn.linear_v"),
        "o": _lin(sd, p + "self_attn.linear_out"),
        "pos": _lin(sd, p + "self_attn.linear_pos", bias=False),
        "pos_bias_u": sd[p + "self_attn.pos_bias_u"],
        "pos_bias_v": sd[p + "self_attn.pos_bias_v"],
        "norm_ff": _ln(sd, p + "norm_ff"),
        "ff1": _lin(sd, p + "feed_forward.w_1"),
        "ff2": _lin(sd, p + "feed_forward.w_2"),
    }


def convert_conformer(sd: StateDict, prefix: str, num_blocks=6, num_up=4) -> dict:
    return {
        "embed": {"lin": _lin(sd, prefix + "embed.out.0"),
                  "ln": _ln(sd, prefix + "embed.out.1")},
        "lookahead": {"conv1": _conv1d(sd, prefix + "pre_lookahead_layer.conv1"),
                      "conv2": _conv1d(sd, prefix + "pre_lookahead_layer.conv2")},
        "blocks": [_conformer_block(sd, f"{prefix}encoders.{i}.") for i in range(num_blocks)],
        "up_conv": _conv1d(sd, prefix + "up_layer.conv"),
        "up_embed": {"lin": _lin(sd, prefix + "up_embed.out.0"),
                     "ln": _ln(sd, prefix + "up_embed.out.1")},
        "up_blocks": [_conformer_block(sd, f"{prefix}up_encoders.{i}.") for i in range(num_up)],
        "after_norm": _ln(sd, prefix + "after_norm"),
    }


def _causal_block(sd: StateDict, p: str) -> dict:
    # torch Sequential: 0=CausalConv1d, 2=LayerNorm (decoder.py:48-57)
    return {"conv": _conv1d(sd, p + "block.0"), "ln": _ln(sd, p + "block.2")}


def _resnet1d(sd: StateDict, p: str) -> dict:
    return {"mlp": _lin(sd, p + "mlp.1"),
            "block1": _causal_block(sd, p + "block1."),
            "block2": _causal_block(sd, p + "block2."),
            "res_conv": _conv1d(sd, p + "res_conv")}


def _tblock(sd: StateDict, p: str) -> dict:
    return {
        "ln1": _ln(sd, p + "norm1"),
        "q": _lin(sd, p + "attn1.to_q", bias=False),
        "k": _lin(sd, p + "attn1.to_k", bias=False),
        "v": _lin(sd, p + "attn1.to_v", bias=False),
        "o": _lin(sd, p + "attn1.to_out.0"),
        "ln3": _ln(sd, p + "norm3"),
        "ff1": _lin(sd, p + "ff.net.0.proj"),
        "ff2": _lin(sd, p + "ff.net.2"),
    }


def convert_flow_decoder(sd: StateDict, prefix: str, n_blocks=4, num_mid=12) -> dict:
    def stage(p, resnet_idx="0", tf_idx="1"):
        return {"resnet": _resnet1d(sd, f"{p}{resnet_idx}."),
                "tblocks": [_tblock(sd, f"{p}{tf_idx}.{j}.") for j in range(n_blocks)]}

    down = stage(prefix + "down_blocks.0.")
    down["downsample"] = _conv1d(sd, prefix + "down_blocks.0.2")
    up = stage(prefix + "up_blocks.0.")
    up["upsample"] = _conv1d(sd, prefix + "up_blocks.0.2")
    return {
        "time_mlp": {"lin1": _lin(sd, prefix + "time_mlp.linear_1"),
                     "lin2": _lin(sd, prefix + "time_mlp.linear_2")},
        "down": down,
        "mid": [stage(f"{prefix}mid_blocks.{i}.") for i in range(num_mid)],
        "up": up,
        "final_block": _causal_block(sd, prefix + "final_block."),
        "final_proj": _conv1d(sd, prefix + "final_proj"),
    }


def _hift_resblock(sd: StateDict, p: str, kernel: int, dilations) -> dict:
    n = len(dilations)
    return {
        "convs1": [_conv1d_wn(sd, f"{p}convs1.{i}") for i in range(n)],
        "convs2": [_conv1d_wn(sd, f"{p}convs2.{i}") for i in range(n)],
        "alpha1": [sd[f"{p}activations1.{i}.alpha"] for i in range(n)],
        "alpha2": [sd[f"{p}activations2.{i}.alpha"] for i in range(n)],
    }


def convert_hift(sd: StateDict, prefix: str = "mel2wav.", cfg=None) -> dict:
    from ..config import HiFTConfig
    cfg = cfg or HiFTConfig()
    f0p = {"convs": [_conv1d_wn(sd, f"{prefix}f0_predictor.condnet.{2 * i}") for i in range(5)],
           "classifier": _lin(sd, prefix + "f0_predictor.classifier")}
    down_rates = [1] + list(cfg.upsample_rates[::-1][:-1])
    down_cum = list(np.cumprod(down_rates))[::-1]
    ups, sdowns, sres, res = [], [], [], []
    for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
        cp = _convt1d_wn(sd, f"{prefix}ups.{i}")
        ups.append({"w": cp["w"], "b": cp.get("b", np.zeros(cp["w"].shape[1], np.float32))})
        d = int(down_cum[i])
        sdowns.append(_conv1d(sd, f"{prefix}source_downs.{i}"))
        sres.append(_hift_resblock(sd, f"{prefix}source_resblocks.{i}.",
                                   cfg.source_resblock_kernel_sizes[i],
                                   cfg.source_resblock_dilation_sizes[i]))
        for kk, dd in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
            res.append(_hift_resblock(sd, f"{prefix}resblocks.{len(res)}.", kk, dd))
    return {
        "f0_predictor": f0p,
        "m_source_linear": _lin(sd, prefix + "m_source.l_linear"),
        "conv_pre": _conv1d_wn(sd, prefix + "conv_pre"),
        "ups": ups,
        "source_downs": sdowns,
        "source_resblocks": sres,
        "resblocks": res,
        "conv_post": _conv1d_wn(sd, prefix + "conv_post"),
    }


def convert_campplus(sd: StateDict, prefix: str = "speaker_encoder.", cfg=None) -> dict:
    def res_block(p, has_shortcut):
        out = {"conv1": _conv2d(sd, p + "conv1"), "bn1": _bn(sd, p + "bn1"),
               "conv2": _conv2d(sd, p + "conv2"), "bn2": _bn(sd, p + "bn2")}
        if has_shortcut:
            out["sc_conv"] = _conv2d(sd, p + "shortcut.0")
            out["sc_bn"] = _bn(sd, p + "shortcut.1")
        return out

    fcm = {
        "conv1": _conv2d(sd, prefix + "head.conv1"), "bn1": _bn(sd, prefix + "head.bn1"),
        "layer1": [res_block(prefix + "head.layer1.0.", True),
                   res_block(prefix + "head.layer1.1.", False)],
        "layer2": [res_block(prefix + "head.layer2.0.", True),
                   res_block(prefix + "head.layer2.1.", False)],
        "conv2": _conv2d(sd, prefix + "head.conv2"), "bn2": _bn(sd, prefix + "head.bn2"),
    }
    xv = prefix + "xvector."
    tdnn = {"conv": _conv1d(sd, xv + "tdnn.linear"), "bn": _bn(sd, xv + "tdnn.nonlinear.batchnorm")}
    blocks, transits = [], []
    from ..config import CAMPPlusConfig
    ccfg = cfg or CAMPPlusConfig()
    for bi, (num_layers, ksz, dil) in enumerate(zip(ccfg.block_layers, ccfg.block_kernels,
                                                    ccfg.block_dilations), start=1):
        layers = []
        for li in range(1, num_layers + 1):
            p = f"{xv}block{bi}.tdnnd{li}."
            layers.append({
                "bn1": _bn(sd, p + "nonlinear1.batchnorm"),
                "linear1": _conv1d(sd, p + "linear1"),
                "bn2": _bn(sd, p + "nonlinear2.batchnorm"),
                "cam_local": _conv1d(sd, p + "cam_layer.linear_local"),
                "cam_l1": _conv1d(sd, p + "cam_layer.linear1"),
                "cam_l2": _conv1d(sd, p + "cam_layer.linear2"),
            })
        blocks.append({"layers": layers})
        transits.append({"bn": _bn(sd, f"{xv}transit{bi}.nonlinear.batchnorm"),
                         "conv": _conv1d(sd, f"{xv}transit{bi}.linear")})
    head = {"out_bn": _bn(sd, xv + "out_nonlinear.batchnorm"),
            "dense_conv": _conv1d(sd, xv + "dense.linear"),
            "dense_bn": _bn(sd, xv + "dense.nonlinear.batchnorm")}
    return {"fcm": fcm, "tdnn": tdnn, "blocks": blocks, "transits": transits, "head": head}


def convert_s3tokenizer(sd: StateDict, prefix: str = "tokenizer.") -> dict:
    """S3TokenizerV2 weights (the `s3tokenizer` package's model_v2 SAN-M
    layout; shipped inside s3gen.safetensors under "tokenizer." per reference
    s3gen.py:53-60). Block count is inferred from the checkpoint."""
    enc = prefix + "encoder."
    n_layers = 0
    while f"{enc}blocks.{n_layers}.attn_ln.weight" in sd:
        n_layers += 1
    if n_layers == 0:
        raise KeyError(f"{enc}blocks.0.attn_ln.weight")
    blocks = []
    for i in range(n_layers):
        p = f"{enc}blocks.{i}."
        blocks.append({
            "ln1": _ln(sd, p + "attn_ln"),
            "q": _lin(sd, p + "attn.query"),
            "k": _lin(sd, p + "attn.key", bias=False),
            "v": _lin(sd, p + "attn.value"),
            "o": _lin(sd, p + "attn.out"),
            "fsmn": _conv1d(sd, p + "attn.fsmn_block"),
            "ln2": _ln(sd, p + "mlp_ln"),
            "fc1": _lin(sd, p + "mlp.0"),
            "fc2": _lin(sd, p + "mlp.2"),
        })
    return {
        "conv1": _conv1d(sd, enc + "conv1"),
        "conv2": _conv1d(sd, enc + "conv2"),
        "blocks": blocks,
        "fsq_proj": _lin(sd, prefix + "quantizer._codebook.project_down"),
    }


# Checkpoint tensors that are legitimately not model weights: DSP buffers the
# rebuild recomputes, train-only params, and modules replaced by design.
S3GEN_IGNORED_KEYS = (
    r"tokenizer\._mel_filters", r"tokenizer\.window",        # ref s3tokenizer.py:44-52
    r".*\.num_batches_tracked",                               # BN step counters
)
T3_IGNORED_KEYS = (
    r"tfmr\.embed_tokens\.weight",    # Llama vocab emb; T3 always feeds inputs_embeds
    r"tfmr\.rotary_emb\.inv_freq",    # derived RoPE buffer
)
VE_IGNORED_KEYS = (
    r"similarity_weight", r"similarity_bias",  # GE2E train-only scalars
)


def convert_s3gen(sd: StateDict, validate: bool = True, cfg=None) -> dict:
    from ..config import S3GenConfig
    cfg = cfg or S3GenConfig()

    def build(d):
        return {
            "tokenizer": convert_s3tokenizer(d, "tokenizer."),
            "flow": {
                "input_embedding": _emb(d, "flow.input_embedding"),
                "spk_embed_affine": _lin(d, "flow.spk_embed_affine_layer"),
                "encoder": convert_conformer(d, "flow.encoder.",
                                             num_blocks=cfg.flow.encoder.num_blocks,
                                             num_up=cfg.flow.encoder.num_up_blocks),
                "encoder_proj": _lin(d, "flow.encoder_proj"),
                "decoder": convert_flow_decoder(d, "flow.decoder.estimator.",
                                                n_blocks=cfg.flow.decoder.n_blocks,
                                                num_mid=cfg.flow.decoder.num_mid_blocks),
            },
            "hift": convert_hift(d, "mel2wav.", cfg=cfg.hift),
            "speaker_encoder": convert_campplus(d, "speaker_encoder.",
                                                cfg=cfg.campplus),
        }
    if not validate:
        return build(sd)
    return _convert_validated(build, sd, ignore=S3GEN_IGNORED_KEYS)


# safetensors dtype codes -> numpy; BF16, which numpy lacks, is read as its
# uint16 bit patterns
_SAFETENSORS_DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16,
                       "BF16": np.uint16, "I64": np.int64, "I32": np.int32, "I16": np.int16,
                       "I8": np.int8, "U8": np.uint8, "BOOL": np.bool_}


def read_safetensors(path: str):
    """One safetensors file (an 8-byte little-endian header length, a JSON
    header, the raw little-endian data) -> ({name: array}, {name: dtype
    code}, metadata). BF16 arrays hold their uint16 bit patterns."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(f.read())
    metadata = header.pop("__metadata__", None) or {}
    arrays, codes = {}, {}
    for name, info in header.items():
        if info["dtype"] not in _SAFETENSORS_DTYPES:
            raise ValueError(f"read_safetensors: {name} has dtype {info['dtype']}")
        dtype = np.dtype(_SAFETENSORS_DTYPES[info["dtype"]])
        lo, hi = info["data_offsets"]
        arrays[name] = np.frombuffer(data, dtype=dtype, count=(hi - lo) // dtype.itemsize,
                                     offset=lo).reshape(info["shape"])
        codes[name] = info["dtype"]
    return arrays, codes, metadata


def load_safetensors(path: str) -> StateDict:
    """Read a safetensors file into numpy, without torch or the safetensors
    package. BF16 tensors are widened to float32 (exactly); every other
    dtype is kept."""
    arrays, codes, _ = read_safetensors(path)
    return {name: (a.astype(np.uint32) << 16).view(np.float32) if codes[name] == "BF16" else a
            for name, a in arrays.items()}
