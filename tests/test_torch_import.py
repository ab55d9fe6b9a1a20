"""The PyTorch port imports without jax: every module of
chatterbox_embed_tpu_torch, and chip_smoke.py, load in a process where
importing jax fails."""
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

BLOCKED_IMPORT = r"""
import importlib, pkgutil, sys

class _NoJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError(f"jax is blocked in this process ({name})")
        return None

sys.meta_path.insert(0, _NoJax())
import chatterbox_embed_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
from chatterbox_embed_tpu_torch import ChatterboxTTS
import chip_smoke
assert not any(m.split(".")[0] in ("jax", "jaxlib") for m in sys.modules)
print(len(names))
"""


def _run(code):
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)


def test_port_imports_with_jax_blocked():
    res = _run(BLOCKED_IMPORT)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 15, res.stdout


@pytest.mark.parametrize("module", ["chatterbox_embed_tpu.models.llama",
                                    "chatterbox_embed_tpu.tts"])
def test_blocker_really_blocks_jax(module):
    """The harness itself: a JAX-package module must fail under the block."""
    code = BLOCKED_IMPORT.split("import chatterbox_embed_tpu_torch")[0] + f"import {module}\n"
    res = _run(code)
    assert res.returncode != 0 and "jax is blocked" in res.stderr


@pytest.mark.parametrize("module", ["chatterbox_embed_tpu_torch.streaming",
                                    "chatterbox_embed_tpu_torch.kernels.fused_decode"])
def test_streaming_and_fused_step_import_with_jax_blocked(module):
    """The streaming path and the fused decode step, each alone in a
    process where importing jax fails."""
    code = (BLOCKED_IMPORT.split("import chatterbox_embed_tpu_torch as pkg")[0]
            + f"import {module}\n"
            + "assert not any(m.split('.')[0] in ('jax', 'jaxlib') for m in sys.modules)\n"
            + "print('imported')\n")
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split()[-1] == "imported"
