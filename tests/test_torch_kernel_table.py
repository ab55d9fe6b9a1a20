"""The port's one kernel table (chatterbox_embed_tpu_torch/kernels:
`table`) on the CPU: it holds every launch counter the kernels' wrappers
keep, each entry names a C entry of its source, and the serving build
(tts._build_serving_kernels) asks `_build` for the sources and entries of
the kernels a request can launch, by their names in the table, and for no
other. Nothing is compiled: `build_all` and `load` are recorded."""
import importlib
import pkgutil

import pytest

from chatterbox_embed_tpu_torch import kernels, tts
from chatterbox_embed_tpu_torch.kernels import _build
from chatterbox_embed_tpu_torch.models import deepseek_v2, llama


def _counters():
    """(wrapper, attribute) of every integer `launches*` attribute on a
    function of a kernel module."""
    found = set()
    for info in pkgutil.iter_modules(kernels.__path__):
        m = importlib.import_module(f"{kernels.__name__}.{info.name}")
        for fn in vars(m).values():
            if callable(fn) and getattr(fn, "__module__", None) == m.__name__:
                found |= {(fn, a) for a, v in vars(fn).items()
                          if a.startswith("launches") and type(v) is int}
    return found


def test_the_table_holds_every_launch_counter():
    table = kernels.table()
    held = {(k.wrapper, k.counter) for k in table.values()}
    assert len(held) == len(table)
    assert _counters() == held
    for name, k in table.items():
        assert k.entry in k.module.SOURCE.read_text(), name
    before = kernels.launches()
    kernels.add_launches({"layer_norm": 3, "moe_experts": 1})
    try:
        after = kernels.launches()
        assert {n: after[n] - before[n] for n in after if after[n] != before[n]} == {
            "layer_norm": 3, "moe_experts": 1}
    finally:
        kernels.add_launches({"layer_norm": -3, "moe_experts": -1})
    assert kernels.launches() == before


@pytest.mark.parametrize("backbone, names", [
    (llama, ("flash_decode", "fused_decode", "rel_attention", "flash_attention", "layer_norm")),
    (deepseek_v2, ("moe_experts", "rel_attention", "flash_attention", "layer_norm")),
], ids=["llama", "deepseek_v2"])
def test_the_serving_build_asks_for_the_backbones_and_s3gens_kernels(backbone, names,
                                                                      monkeypatch):
    built, loaded = [], []
    monkeypatch.setattr(_build, "build_all", lambda sources: built.append(list(sources)))
    monkeypatch.setattr(_build, "load", lambda *args: loaded.append(args))
    tts._build_serving_kernels(backbone.SERVING_KERNELS)
    mods = [importlib.import_module(f"{kernels.__name__}.{n}") for n in names]
    assert built == [[m.SOURCE for m in mods]]
    assert loaded == [(m.SOURCE, f"cbx_{n}", m._ARGTYPES) for m, n in zip(mods, names)]
