"""The PyTorch port stands alone: every module of chatterbox_embed_tpu_torch,
and chip_smoke.py, load in a process where importing jax, jaxlib or the JAX
package chatterbox_embed_tpu fails; the port's copy of config.py equals the
JAX package's; and its entry points take the CUDA card by default, raising
where there is none instead of stepping down to the CPU."""
import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

BLOCKED_IMPORT = r"""
import importlib, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "chatterbox_embed_tpu")

class _NoJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name.split('.')[0]} is blocked in this process ({name})")
        return None

sys.meta_path.insert(0, _NoJax())
import chatterbox_embed_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
from chatterbox_embed_tpu_torch import ChatterboxTTS, ChatterboxVC
import chip_smoke
assert not any(m.split(".")[0] in BLOCKED for m in sys.modules)
print(len(names))
"""


def _run(code):
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)


def test_port_imports_with_jax_blocked():
    res = _run(BLOCKED_IMPORT)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 63, res.stdout


@pytest.mark.parametrize("module", ["chatterbox_embed_tpu.models.llama",
                                    "chatterbox_embed_tpu.tts"])
def test_blocker_really_blocks_jax(module):
    """The harness itself: a JAX-package module must fail under the block."""
    code = BLOCKED_IMPORT.split("import chatterbox_embed_tpu_torch")[0] + f"import {module}\n"
    res = _run(code)
    assert res.returncode != 0 and "chatterbox_embed_tpu is blocked" in res.stderr


@pytest.mark.parametrize("module", ["chatterbox_embed_tpu.config",
                                    "chatterbox_embed_tpu.utils.weights", "jax.numpy"])
def test_blocker_refuses_jax_free_modules_of_the_jax_package_too(module):
    """A module of the JAX package that imports no jax is refused all the
    same, and the port's namesake package is not."""
    code = BLOCKED_IMPORT.split("import chatterbox_embed_tpu_torch")[0] + f"import {module}\n"
    res = _run(code)
    assert res.returncode != 0 and "is blocked in this process" in res.stderr
    ok = _run(BLOCKED_IMPORT.split("import chatterbox_embed_tpu_torch")[0]
              + "import chatterbox_embed_tpu_torch.config\nprint('imported')\n")
    assert ok.returncode == 0 and ok.stdout.split()[-1] == "imported", ok.stderr


@pytest.mark.parametrize("module", ["chatterbox_embed_tpu_torch.streaming",
                                    "chatterbox_embed_tpu_torch.kernels.fused_decode",
                                    "chatterbox_embed_tpu_torch.vc",
                                    "chatterbox_embed_tpu_torch.probes.weight_stream",
                                    "chatterbox_embed_tpu_torch.probes.decode_anatomy",
                                    "chatterbox_embed_tpu_torch.chunking",
                                    "chatterbox_embed_tpu_torch.text.sanitizer",
                                    "chatterbox_embed_tpu_torch.parameters.adaptive",
                                    "chatterbox_embed_tpu_torch.quality.analyzer",
                                    "chatterbox_embed_tpu_torch.stitching.stitcher",
                                    "chatterbox_embed_tpu_torch.models.alignment",
                                    "chatterbox_embed_tpu_torch.tts",
                                    "chatterbox_embed_tpu_torch.models.t3_engine",
                                    "chatterbox_embed_tpu_torch.serving.continuous",
                                    "chatterbox_embed_tpu_torch.serving.jobs",
                                    "chatterbox_embed_tpu_torch.serving.storage",
                                    "chatterbox_embed_tpu_torch.serving.worker",
                                    "chatterbox_embed_tpu_torch.utils.misc"])
def test_streaming_and_fused_step_import_with_jax_blocked(module):
    """The streaming path, the fused decode step, voice conversion, the
    probes, and the long-text helpers and pipeline with the alignment
    guard, each alone in a process where importing jax or the JAX package
    fails."""
    code = (BLOCKED_IMPORT.split("import chatterbox_embed_tpu_torch as pkg")[0]
            + f"import {module}\n"
            + "assert not any(m.split('.')[0] in BLOCKED for m in sys.modules)\n"
            + "print('imported')\n")
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split()[-1] == "imported"


def test_no_source_line_imports_the_jax_package():
    import re
    pat = re.compile(r"^\s*(from|import)\s+(chatterbox_embed_tpu|jax|jaxlib)\b(?!_)", re.M)
    files = list((ROOT / "chatterbox_embed_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 35
    hits = [str(f.relative_to(ROOT)) for f in files if pat.search(f.read_text())]
    assert hits == []


def test_copied_config_equals_the_jax_packages():
    """Every dataclass, field, default and constant of the port's config.py
    equals the JAX package's."""
    import chatterbox_embed_tpu.config as jc
    import chatterbox_embed_tpu_torch.config as tc

    def public(mod):
        return {k: v for k, v in vars(mod).items()
                if not k.startswith("_") and k not in ("annotations",)
                and not isinstance(v, type(dataclasses))}      # no modules

    jpub, tpub = public(jc), public(tc)
    assert set(jpub) == set(tpub)
    n_classes = n_fields = 0
    for name, jv in jpub.items():
        tv = tpub[name]
        if dataclasses.is_dataclass(jv) and isinstance(jv, type):
            n_classes += 1
            jf, tf = dataclasses.fields(jv), dataclasses.fields(tv)
            assert [f.name for f in jf] == [f.name for f in tf], name
            assert [str(f.type) for f in jf] == [str(f.type) for f in tf], name
            # defaults and default factories, compared through an instance
            assert dataclasses.asdict(jv()) == dataclasses.asdict(tv()), name
            assert jv.__dataclass_params__.frozen == tv.__dataclass_params__.frozen
            for attr in set(vars(jv)) | set(vars(tv)):           # properties, methods
                if not attr.startswith("__"):
                    assert attr in vars(jv) and attr in vars(tv), (name, attr)
            n_fields += len(jf)
        elif callable(jv):
            assert callable(tv), name
        else:
            assert jv == tv and type(jv) is type(tv), name
    assert n_classes >= 10 and n_fields >= 80
    # derived properties agree on the full config
    assert tc.T3Config().max_speech_seq_len == jc.T3Config().max_speech_seq_len
    small = dict(hidden_size=64, num_layers=2)
    assert dataclasses.asdict(tc.replace(tc.LlamaConfig(), **small)) == dataclasses.asdict(
        jc.replace(jc.LlamaConfig(), **small))


ENTRY_POINTS = [
    "ChatterboxTTS.from_random(config=TINY)",
    "ChatterboxTTS(None, None, None, config=TINY)",
    "ChatterboxTTS.from_local('.', config=TINY)",
    "ChatterboxVC.from_random(config=TINY)",
    "ChatterboxVC(None, config=TINY)",
    "ChatterboxVC.from_local('.', config=TINY)",
    "Conditionals.load('nothing.pt')",
    "L.Init(0)",
    "Draws(0)",
    "sampling_param([0.5, 0.6], 2)",
    "llama.init_cache(TINY.t3.llama, 2, 8)",
    "t3.generate(None, None, np.zeros((1, 4), np.int32), cfg=TINY.t3)",
    "t3.start_generation(None, None, np.zeros((1, 4), np.int32), cfg_weight=0.5, "
    "max_new_tokens=4, cfg=TINY.t3)",
    "t3.generate_batch(None, None, np.zeros((2, 4), np.int32), cfg=TINY.t3)",
    "next(t3.generate_stream(None, None, np.zeros((1, 4), np.int32), cfg=TINY.t3))",
    "audio_io.load_audio(WAV, sr=16_000)",
    "default_device()",
    "t3_engine.engine_init(TINY.t3, slots=1, text_bucket=8, cond_w=34, max_new_tokens=4)",
    "t3_engine.prefill_request(None, None, np.zeros((1, 4), np.int32), text_bucket=8, "
    "p_len=44, cfg=TINY.t3)",
    "t3_engine.ContinuousDecoder(None, TINY.t3, slots=1)",
    "training.init_t3_train_state(None)",
    "training.init_flow_train_state(None)",
    "parallel.make_mesh(2)",
    "parallel.make_dp_tp_mesh()",
    "ChatterboxTTS.from_random(config=TINY, device='cpu').enable_mesh(2, tp=1)",
]


@pytest.mark.parametrize("call", ENTRY_POINTS)
def test_entry_points_need_the_card_unless_asked_for_the_cpu(call, monkeypatch, tmp_path):
    """With no CUDA card, a call without `device` raises an error that names
    the missing card, before it touches its other arguments; nothing steps
    down to the CPU."""
    import numpy as np                                     # noqa: F401  (used by eval)
    import torch
    from chatterbox_embed_tpu_torch import ChatterboxTTS, ChatterboxVC   # noqa: F401
    from chatterbox_embed_tpu_torch.conditionals import Conditionals     # noqa: F401
    from chatterbox_embed_tpu_torch.device import default_device         # noqa: F401
    from chatterbox_embed_tpu_torch.models import layers as L            # noqa: F401
    from chatterbox_embed_tpu_torch.models import llama, t3, t3_engine    # noqa: F401
    from chatterbox_embed_tpu_torch.ops.sampling import Draws, sampling_param   # noqa: F401
    from chatterbox_embed_tpu_torch import parallel, training             # noqa: F401
    from chatterbox_embed_tpu_torch.utils import audio_io
    from torch_parity import tiny_pipeline_config
    TINY = tiny_pipeline_config()                          # noqa: F841, N806
    WAV = str(tmp_path / "tone.wav")                       # noqa: F841, N806
    audio_io.write_wav(WAV, np.sin(np.arange(2400) * 0.05).astype(np.float32), 24_000)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        eval(call)


def test_device_cpu_runs_and_no_default_names_the_cpu():
    import importlib
    import inspect
    import pkgutil
    import torch
    import chatterbox_embed_tpu_torch as pkg
    from chatterbox_embed_tpu_torch import ChatterboxTTS, ChatterboxVC
    from chatterbox_embed_tpu_torch.conditionals import Conditionals
    from chatterbox_embed_tpu_torch.device import resolve_device
    from chatterbox_embed_tpu_torch.models import layers as L
    from chatterbox_embed_tpu_torch.models import llama, t3, t3_engine
    from chatterbox_embed_tpu_torch.ops import sampling
    from chatterbox_embed_tpu_torch import training
    from chatterbox_embed_tpu_torch.utils import audio_io
    from torch_parity import tiny_pipeline_config
    tiny = tiny_pipeline_config()
    tts = ChatterboxTTS.from_random(config=tiny, device="cpu")
    assert tts.device == torch.device("cpu") and tts.ve_params is not None
    assert tts.t3_params["speech_head"]["w"].device.type == "cpu"
    assert resolve_device("cpu") == torch.device("cpu")
    assert sampling.Draws(0, "cpu").gumbel(0, (2,)).device.type == "cpu"
    for fn in (ChatterboxTTS.__init__, ChatterboxTTS.from_random, ChatterboxTTS.from_local,
               ChatterboxVC.__init__, ChatterboxVC.from_random, ChatterboxVC.from_local,
               Conditionals.load, L.Init.__init__, sampling.Draws.__init__,
               sampling.sampling_param, llama.init_cache, t3.generate, t3.generate_batch,
               t3.generate_stream, t3.start_generation, audio_io.load_audio,
               t3_engine.engine_init, t3_engine.prefill_request,
               t3_engine.ContinuousDecoder.__init__, training.init_t3_train_state,
               training.init_flow_train_state):
        assert inspect.signature(fn).parameters["device"].default is None, fn
    # and nothing else in the package: every function or method that takes a
    # `device` either requires it or defaults to None (the card)
    seen = 0
    for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        mod = importlib.import_module(info.name)
        owners = [mod] + [c for c in vars(mod).values()
                          if inspect.isclass(c) and c.__module__ == mod.__name__]
        for owner in owners:
            for name, fn in vars(owner).items():
                fn = getattr(fn, "__func__", fn)               # class and static methods
                if not inspect.isfunction(fn) or fn.__module__ != mod.__name__:
                    continue
                par = inspect.signature(fn).parameters.get("device")
                if par is not None:
                    seen += 1
                    assert par.default in (None, inspect.Parameter.empty), (info.name, name)
    assert seen >= 20
