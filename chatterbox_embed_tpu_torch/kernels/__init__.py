"""Hand-written Hopper kernels of the PyTorch port, each beside its plain
PyTorch version, and their one table (`table`): what exists to be built,
loaded and counted. Importing the package imports no kernel module and
builds nothing; `table()` imports the modules on its first call."""
from __future__ import annotations

import functools
import importlib
from typing import Callable, NamedTuple


class Kernel(NamedTuple):
    """A counted C entry: its kernel's module (SOURCE, _ARGTYPES), the
    wrapper whose attribute `counter` counts its launches, and its name in
    the library."""
    module: object
    wrapper: Callable
    counter: str
    entry: str


# name: (module, wrapper, counter, C entry). K1 and K1s, and their int8
# entries, are four counters of one source; K3b-dq and K3b-dkv two of another.
_K1 = ("flash_decode", "decode_attention")
_K3B = ("flash_attention_bwd", "flash_attention_backward")
_ROWS = {
    "flash_decode": (*_K1, "launches", "cbx_flash_decode"),
    "flash_decode_deferred": (*_K1, "launches_deferred", "cbx_flash_decode"),
    "rel_attention": ("rel_attention", "rel_attention", "launches", "cbx_rel_attention"),
    "flash_attention": ("flash_attention", "flash_attention", "launches", "cbx_flash_attention"),
    "flash_attention_bwd_dq": (*_K3B, "launches_dq", "cbx_flash_attention_bwd_dq"),
    "flash_attention_bwd_dkv": (*_K3B, "launches_dkv", "cbx_flash_attention_bwd_dkv"),
    "flash_decode_int8": (*_K1, "launches_int8", "cbx_flash_decode"),
    "flash_decode_int8_deferred": (*_K1, "launches_int8_deferred", "cbx_flash_decode"),
    "fused_decode": ("fused_decode", "fused_decode_step", "launches", "cbx_fused_decode"),
    "moe_experts": ("moe_experts", "grouped_swiglu", "launches", "cbx_moe_experts"),
    "layer_norm": ("layer_norm", "layer_norm", "launches", "cbx_layer_norm"),
    "weight_stream": ("weight_stream", "stream_once", "launches", "cbx_weight_stream"),
    "decode_anatomy": ("decode_anatomy", "attn", "launches", "cbx_decode_anatomy"),
}


@functools.cache
def table() -> dict:
    """name -> Kernel, for every launch counter of the port's kernels."""
    out = {}
    for name, (module, wrapper, counter, entry) in _ROWS.items():
        m = importlib.import_module(f".{module}", __name__)
        out[name] = Kernel(m, getattr(m, wrapper), counter, entry)
    return out


def launches() -> dict:
    """{name: launches} as the table's counters hold them now."""
    return {name: getattr(k.wrapper, k.counter) for name, k in table().items()}


def add_launches(counts: dict) -> None:
    """Add {name: n} to the table's counters."""
    for name, n in counts.items():
        k = table()[name]
        setattr(k.wrapper, k.counter, getattr(k.wrapper, k.counter) + n)
