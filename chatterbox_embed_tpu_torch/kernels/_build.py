"""The one build route of the port's CUDA kernels: `nvcc` compiles a source
under `csrc/` for sm_90a into a shared library with a plain C interface,
which the kernel's wrapper loads with ctypes.

Each library lands in `chatterbox_embed_tpu_torch/_build/<hash>/lib<stem>.so`
(git-ignored). The hash covers the source, every header in `csrc/` and the
compiler flags, so a changed source or header rebuilds and an unchanged one
loads the earlier build. Nothing is built when a module is imported: a
wrapper builds its library the first time a CUDA tensor reaches it, and
`build_all` builds several at once, one `nvcc` process each. Without `nvcc`,
or when it fails, the build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_ROOT = PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
DEFAULT_CUDA_HOME = "/usr/local/cuda"

_loaded: dict = {}


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 DEFAULT_CUDA_HOME):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, PATH): "
                           "the port's CUDA kernels cannot be built")
    return found


def library_path(source: Path) -> Path:
    """Where the build of `source` lives, keyed by the source, the headers
    beside it and the compiler flags."""
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16] / f"lib{source.stem}.so"


def _start(source: Path, nvcc: str):
    out = library_path(source)
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return out, tmp, cmd, proc


def _finish(out: Path, tmp: str, cmd, proc) -> None:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
    os.replace(tmp, out)         # atomic: a concurrent build never sees half a file


def build_all(sources) -> dict:
    """Compile every source not built yet, one nvcc process each, all
    started together. Returns {source: (library path, seconds until its
    build ended)}; an existing build counts 0 s. Raises if nvcc is missing
    or any build fails (after every started build has ended)."""
    t0 = time.time()
    done = {src: (library_path(src), 0.0) for src in map(Path, sources)}
    todo = [src for src, (out, _) in done.items() if not out.is_file()]
    nvcc = find_nvcc() if todo else None
    running = [(src, _start(src, nvcc)) for src in todo]
    errors = []
    for src, job in running:
        try:
            _finish(*job)
            done[src] = (job[0], time.time() - t0)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return done


def build(source: Path) -> Path:
    """Compile one source unless it is built already; returns the library."""
    return build_all([source])[Path(source)][0]


def load(source: Path, entry: str, argtypes) -> ctypes.CDLL:
    """The library of `source` (built on first use), with the C entry
    `entry` declared to return int and take `argtypes` (a source may have
    several entries; each is declared on its first load)."""
    lib = _loaded.get((source, entry))
    if lib is None:
        lib = _loaded.get(source) or ctypes.CDLL(str(build(source)))
        fn = getattr(lib, entry)
        fn.restype = ctypes.c_int
        fn.argtypes = list(argtypes)
        _loaded[source] = _loaded[(source, entry)] = lib
    return lib
