"""Small shared utilities, the port's own copy of
`chatterbox_embed_tpu/utils/misc.py` (reference: utils.py: availability
probes, git sha, dB helpers, AttrDict)."""
from __future__ import annotations

import shutil
import subprocess
from typing import Optional

import numpy as np

REPO_ID = "ResembleAI/chatterbox"


class AttrDict(dict):
    """dict with attribute access (reference: models/utils.py:1-4)."""
    __getattr__ = dict.__getitem__
    __setattr__ = dict.__setitem__  # type: ignore[assignment]


def get_git_sha() -> Optional[str]:
    try:
        return subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                              capture_output=True, text=True, timeout=5
                              ).stdout.strip() or None
    except Exception:
        return None


def ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None


def peak_db(x: np.ndarray) -> float:
    peak = float(np.max(np.abs(x))) if np.asarray(x).size else 0.0
    return 20.0 * np.log10(max(peak, 1e-12))


def rms_db(x: np.ndarray) -> float:
    rms = float(np.sqrt(np.mean(np.square(np.asarray(x, np.float64))))) if np.asarray(x).size else 0.0
    return 20.0 * np.log10(max(rms, 1e-12))
