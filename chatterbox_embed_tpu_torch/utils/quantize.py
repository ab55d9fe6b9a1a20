"""Optional int8 weight quantization: the port's copy of
`chatterbox_embed_tpu/utils/quantize.py`, over the port's
`layers.quantize_linear`.

Symmetric per-output-channel scales on the T3 backbone's linears
(`quantize_t3`) and on the flow stack's (`quantize_s3gen`: the conformer
encoder and the CFM estimator); embeddings, norms, heads, convolutions,
HiFT, the x-vector and the tokenizer stay full precision. The conformer's
`pos` projection stays fp too: K2 reads it raw (conformer._rel_factors reads
p["pos"]["w"]). `layers.linear` dequantises each weight before its matmul,
so an int8 tree reads fewer bytes where it is stored, not in the product.
"""
from __future__ import annotations

from ..config import T3Config
from ..models import backbone
from ..models import layers as L


def quantize_llama(llama_params: dict) -> dict:
    out = {"layers": [], "norm": llama_params["norm"]}
    for lp in llama_params["layers"]:
        out["layers"].append({
            "ln1": lp["ln1"], "ln2": lp["ln2"],
            "q": L.quantize_linear(lp["q"]),
            "k": L.quantize_linear(lp["k"]),
            "v": L.quantize_linear(lp["v"]),
            "o": L.quantize_linear(lp["o"]),
            "gate": L.quantize_linear(lp["gate"]),
            "up": L.quantize_linear(lp["up"]),
            "down": L.quantize_linear(lp["down"]),
        })
    return out


def quantize_t3(t3_params: dict, cfg: T3Config = T3Config()) -> dict:
    """T3 with its backbone's linears in int8 (`quantize_llama`); a backbone
    whose int8 weights are not ported (cfg.llama, models/backbone.py)
    raises."""
    backbone.check(cfg.llama, int8_weights=True)
    out = dict(t3_params)
    out["llama"] = quantize_llama(t3_params["llama"])
    return out


def quantize_flow_decoder(dec: dict) -> dict:
    def tblock(b):
        return {**b, "q": L.quantize_linear(b["q"]), "k": L.quantize_linear(b["k"]),
                "v": L.quantize_linear(b["v"]), "o": L.quantize_linear(b["o"]),
                "ff1": L.quantize_linear(b["ff1"]),
                "ff2": L.quantize_linear(b["ff2"])}

    def stage(s):
        out = dict(s)
        out["resnet"] = {**s["resnet"], "mlp": L.quantize_linear(s["resnet"]["mlp"])}
        out["tblocks"] = [tblock(b) for b in s["tblocks"]]
        return out

    out = dict(dec)
    out["down"] = stage(dec["down"])
    out["mid"] = [stage(s) for s in dec["mid"]]
    out["up"] = stage(dec["up"])
    return out


def quantize_conformer(enc: dict) -> dict:
    def block(b):
        return {**b, "q": L.quantize_linear(b["q"]), "k": L.quantize_linear(b["k"]),
                "v": L.quantize_linear(b["v"]), "o": L.quantize_linear(b["o"]),
                "ff1": L.quantize_linear(b["ff1"]),
                "ff2": L.quantize_linear(b["ff2"])}

    out = dict(enc)
    out["blocks"] = [block(b) for b in enc["blocks"]]
    out["up_blocks"] = [block(b) for b in enc["up_blocks"]]
    return out


def quantize_s3gen(s3_params: dict) -> dict:
    """int8 linears on the flow stack (conformer encoder + CFM estimator);
    HiFT, the x-vector and the tokenizer untouched."""
    out = dict(s3_params)
    flow = dict(s3_params["flow"])
    flow["encoder"] = quantize_conformer(flow["encoder"])
    flow["decoder"] = quantize_flow_decoder(flow["decoder"])
    out["flow"] = flow
    return out
