"""Build-and-check run of the port's decode kernels on one CUDA card (an
H100): the flash-decode kernel (K1, K1s), the fused T3 step (K4) and the
decode-anatomy probe (K6), all over the walk of `csrc/decode_walk.cuh`.
Shorter than the smoke run and more talkative:

    python3 scripts/torch_decode_check.py [--no-time] [--no-k4] [--builds LABEL=DIR,...]
                                          [--stamps]

1. compiles `csrc/flash_decode.cu`, `fused_decode.cu` and `decode_anatomy.cu`
   once more with `-Xptxas -v` beside the normal build and prints, per
   kernel, the registers, spills and any ptxas warning; and for each of
   flash_decode.cu's four instances (fp32 / bf16 q, a float or an int8
   cache) what the CUDA runtime reports: registers, local bytes and
   resident blocks an SM (`flash_decode.kernel_info`);
2. runs the smoke's K1 / K1s checks (every case, fp32 and bf16, B = 2 and
   16, Lc 512 and 1280, timed beside the library's call), the int8 entry's
   (`chip_smoke.phase_int8_kernel_check`: every case, the planted scale
   fault, the engine's spans), the K6 checks, and, unless `--no-k4`, K4 on
   random full-width weights (30 layers, d = 1024): a chain at the lowest
   positions and one near the top of Lc 512, fp32 against the plain
   version, and the first layer in bf16;
3. unless `--no-time`: K1's bf16 device time and kernels a call, the int8
   entry's time at INT8_SHAPES beside bf16 K1 / K1s on the same shape, K6's
   probe (warm and with L2 flushed, pos 44 and 379) and K4's time
   (`chip_smoke.fused_times`: CUDA events over steps queued behind a spin
   kernel, B = 2 at pos 44, 260 and 507, and 4, 8 and 16 rows at 507);
4. with `--builds`: scratch builds, each from a directory that holds a copy
   of `csrc/` with a design choice changed by hand (outside the tree, under
   the git-ignored `bench_out/`). A build covers each kernel whose own source
   differs from the shipped one: `flash_decode.cu` (K1; its
   `decode_walk.cuh` comes from the same directory) is checked as the
   int8 entry is in 2 and its int8 entry timed at INT8_SHAPES, and
   `fused_decode.cu` (K4) is checked and timed as in 2 and 3; both in
   turns with the shipped build (K1: shipped, builds..., shipped,
   builds reversed..., shipped; K4: shipped, builds..., shipped);
5. with `--stamps`: K4's phases timed inside the kernel, a scratch build
   (STAMP_EDITS, of the shipped source and of each `--builds` one) in which
   thread 0 of every block reads clock64() just before and just after each
   of the 151 grid barriers of a step: per phase, the slowest block's work
   and the barrier's own wait (the last block's), and the SM clock the step
   ran at, for 30 steps that each start with the card idle and for one
   queued behind other steps.

`--no-k4` stops after K1's part (its builds and times): no K4, no K6 probe.
Exits non-zero if a check fails. Needs CUDA and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
import time
from functools import partial
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from chatterbox_embed_tpu_torch.kernels import _build  # noqa: E402
from chatterbox_embed_tpu_torch.kernels import decode_anatomy as da  # noqa: E402
from chatterbox_embed_tpu_torch.kernels import flash_decode as fd  # noqa: E402
from chatterbox_embed_tpu_torch.kernels import fused_decode as fu  # noqa: E402
from chatterbox_embed_tpu_torch.probes import timing  # noqa: E402

OUT = _build.BUILD_ROOT / "decode_check"
K1 = "flash_decode.cu"
K4 = "fused_decode.cu"
# the int8 entry's timed shapes (PERF.md §6), bf16 q: (B, Lc, deferred) with
# the smoke's holes at pos 4 + 3/4 of the rest; and the engine's spans
INT8_SHAPES = ((cs.KERNEL_B_BATCH, 512, False), (cs.KERNEL_B_BATCH, 1280, False),
               (cs.KERNEL_B, 512, True))
MODULES = {"flash_decode": fd, "fused_decode": fu, "decode_anatomy": da}
# K4's barriers timed from inside: g_k4_stamps[site][block] = (cycles since
# the block left the previous barrier until the whole block reached this
# one, cycles it then waited in grid.sync()); site 0 the barrier before the
# first layer, site 1 + 5 * layer + k the one that ends phase P(k+1); then
# block 0's clock64() and %globaltimer (ns) at its start and after its last
# barrier, whose ratio is the SM clock the step ran at
STAMP_SITES, STAMP_BLOCKS = 151, 264
_STAMP_DEFS = (
    "namespace cg = cooperative_groups;\n"
    f"constexpr int kStampSites = {STAMP_SITES}, kStampBlocks = {STAMP_BLOCKS};\n"
    "constexpr int kStampClock = kStampSites * kStampBlocks * 2;\n"
    "__device__ long long g_k4_stamps[kStampClock + 4];\n"
    "__device__ __forceinline__ long long stamp_ns() { long long t; "
    'asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)); return t; }\n'
    "#define STAMP_BEGIN() int stamp_site = 0; long long stamp_prev = clock64(); "
    "if (blockIdx.x == 0 && threadIdx.x == 0) { g_k4_stamps[kStampClock] = stamp_prev; "
    "g_k4_stamps[kStampClock + 1] = stamp_ns(); }\n"
    "#define STAMP_SYNC() do { __syncthreads(); const long long a_ = clock64(); grid.sync(); "
    "const long long e_ = clock64(); if (threadIdx.x == 0 && stamp_site < kStampSites && "
    "blockIdx.x < kStampBlocks) { long long* s_ = g_k4_stamps + ((size_t)stamp_site * "
    "kStampBlocks + blockIdx.x) * 2; s_[0] = a_ - stamp_prev; s_[1] = e_ - a_; } "
    "if (blockIdx.x == 0 && threadIdx.x == 0) { g_k4_stamps[kStampClock + 2] = e_; "
    "g_k4_stamps[kStampClock + 3] = stamp_ns(); } "
    "stamp_prev = e_; ++stamp_site; } while (0)\n")
STAMP_EDITS = [
    (K4, r"grid\.sync\(\);", "STAMP_SYNC();", 6),
    (K4, r"namespace cg = cooperative_groups;\n", _STAMP_DEFS),
    (K4, r"cg::grid_group grid = cg::this_grid\(\);",
     "cg::grid_group grid = cg::this_grid();\n  STAMP_BEGIN();"),
    (K4, r"\Z", '\nextern "C" int cbx_k4_stamps(void* dst, size_t bytes) {\n'
                 "  return (int)cudaMemcpyFromSymbol(dst, g_k4_stamps, bytes);\n}\n"),
]


def _nvcc(src: Path, lib: Path, *extra):
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, *extra, "-o", str(lib), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def ptxas_report() -> None:
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = [(m.SOURCE, _nvcc(m.SOURCE, OUT / f"ptxas_{m.SOURCE.stem}.so", "-Xptxas", "-v"))
            for m in MODULES.values()]
    for src, proc in jobs:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            print(text[-6000:])
            raise SystemExit(f"nvcc failed on {src.name}")
        _print_ptxas(src.stem, text)
    occupancy_report("shipped")


def occupancy_report(label: str) -> None:
    """Registers, local bytes and resident blocks an SM of flash_decode.cu's
    four instances in the library K1's wrapper launches."""
    for dtype in (torch.float32, torch.bfloat16):
        for int8 in (False, True):
            cs.log("occupancy", build=label, kernel="flash_decode", q=str(dtype)[6:],
                   cache="int8" if int8 else str(dtype)[6:], **fd.kernel_info(dtype, int8))


def _print_ptxas(label: str, text: str) -> None:
    name = None
    for line in text.splitlines():
        found = re.search(r"Compiling entry function '(\S+)'", line)
        if found:
            name = found.group(1)
        elif "registers" in line or "spill" in line:
            print(f"[ptxas] {label} {(name or '')[:90]}: {line.strip()[:200]}")
        elif "warning" in line.lower():
            print(f"[ptxas] {label} WARNING {line.strip()[:300]}")


def differs(src, name: str) -> bool:
    """Whether the directory `src` holds a `name` other than the shipped one."""
    return (Path(src) / name).read_bytes() != (_build.CSRC / name).read_bytes()


def build_libs(builds: dict, name: str, mod) -> dict:
    """label -> a directory holding a copy of csrc/ (with `name` edited by
    hand, say); each one's `name` built in parallel with -Xptxas -v into the
    build directory and loaded, its C entry declared as `mod`'s. One that
    does not build is reported and left out."""
    jobs = {}
    for label, src in builds.items():
        stem = re.sub(r"\W", "_", f"{label}_{Path(name).stem}")
        lib = OUT / f"lib{stem}.so"
        jobs[label] = (lib, _nvcc(Path(src) / name, lib, "-Xptxas", "-v"))
    libs = {}
    for label, (lib, proc) in jobs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"[build] {label} FAILED:\n{text[-4000:]}", flush=True)
            continue
        _print_ptxas(label, text)
        cdll = ctypes.CDLL(str(lib))
        entry = getattr(cdll, "cbx_" + Path(name).stem)
        entry.restype = ctypes.c_int
        entry.argtypes = list(mod._ARGTYPES)
        libs[label] = cdll
    return libs


def stamped_copy(src: Path, label: str) -> Path:
    """A copy of the csrc/ directory `src` under the build directory with
    STAMP_EDITS applied to its fused_decode.cu."""
    root = OUT / re.sub(r"\W", "_", label)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(src, root)
    text = (root / K4).read_text()
    for _, pattern, repl, *count in STAMP_EDITS:
        text, n = re.subn(pattern, repl, text)
        if n != (count[0] if count else 1):
            raise SystemExit(f"stamps: pattern {pattern!r} matched {n} times in {src}")
    (root / K4).write_text(text)
    return root


class patched:
    """Within the block, the wrapper of kernel module `mod` (K1's or K4's)
    launches `cdll`; its workspace is made anew."""

    def __init__(self, mod, cdll):
        self.mod, self.cdll = mod, cdll

    def __enter__(self):
        self.keep = self.mod._library
        self.mod._library = lambda: self.cdll
        self.mod._WORKSPACE.clear()

    def __exit__(self, *exc):
        self.mod._library = self.keep
        self.mod._WORKSPACE.clear()


def full_width():
    from chatterbox_embed_tpu_torch.config import ChatterboxConfig
    from chatterbox_embed_tpu_torch.models import layers as L
    from chatterbox_embed_tpu_torch.models import llama
    cfg = ChatterboxConfig().t3.llama
    params = llama.init(L.Init(0, "cuda"), cfg)
    fused32 = fu.stack_for_fused(params, cfg, torch.float32)
    fused16 = fu.stack_for_fused(params, cfg, torch.bfloat16)
    del params
    return cfg, fused32, fused16


def k4_checks(cfg, fused32, fused16, g) -> None:
    cut16 = {"wall": fused16["wall"][:1], "ln1": fused16["ln1"][:1], "ln2": fused16["ln2"][:1],
             "fnorm": fused16["fnorm"]}
    lc = cs.KERNEL_LC[0]
    for pos0, steps in ((cs.FUSED_START + 1, cs.FUSED_LOW_STEPS), (None, 4)):
        for fz, dtype in ((fused32, torch.float32), (cut16, torch.bfloat16)):
            res, _ = cs._fused_chain(fz, cfg, lc, dtype, g, steps=steps, pos0=pos0)
            for t_i, tensor in enumerate(("h", "kv_rows")):
                cs._check_err("fused_decode", res["kernel"][t_i], res["plain"][t_i],
                              cs.FUSED_TOL[dtype], dtype == torch.bfloat16, tensor=tensor,
                              dtype=str(dtype)[6:], pos0=pos0, steps=steps)
            del res
    torch.cuda.empty_cache()


def k6_checks(g) -> None:
    from chatterbox_embed_tpu_torch.probes import decode_anatomy as pda
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn(shape, generator=g, device="cuda").to(dtype)
                   for shape in ((1, pda.F), (pda.TOTAL, pda.F), (pda.TOTAL, pda.F)))
        for mode in da.MODES:
            for pos in (0, 44, 63, 64, 379, pda.TOTAL - 1):
                cs._check_err("decode_anatomy", da.attn(q, k, v, pos, mode),
                              da.attn_reference(q, k, v, pos, mode), cs.TOL[dtype],
                              mode == "load_only", mode=mode, pos=pos, dtype=str(dtype)[6:])


def _k4_step(cfg, fused16, g, pos=507):
    lc = cs.KERNEL_LC[0]
    x = torch.randn((cs.KERNEL_B, cfg.hidden_size), generator=g, device="cuda").to(torch.bfloat16)
    ck, cv = (torch.randn((cfg.num_layers, lc, cs.KERNEL_B, cfg.num_heads, cfg.head_dim),
                          generator=g, device="cuda").to(torch.bfloat16) for _ in range(2))
    return lambda: fu.fused_decode_step(fused16, x, ck, cv, pos, cs.FUSED_START, cfg,
                                        torch.bfloat16)


def _idle(seconds: float = 0.002) -> None:
    torch.cuda.synchronize()
    time.sleep(seconds)


def k4_stamps(cfg, fused16, g, card, label, cdll, n: int = 30) -> None:
    """K4's phases from inside the kernel (STAMP_EDITS) at pos 507: n single
    steps, each after 2 ms with the card idle (`from_idle`), then the last
    of n steps queued behind a spin kernel (`queued`). Per step: block 0's
    span from its start to its last barrier (`kernel_us`), the SM clock it
    ran at (clock64 over %globaltimer), and per phase P1-P5, averaged over
    the 30 layers, the slowest block's work and the barrier's own wait (the
    least wait of any block: the last to arrive), in microseconds."""
    fn = cdll.cbx_k4_stamps
    fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_void_p, ctypes.c_size_t]
    grid = torch.cuda.get_device_properties(0).multi_processor_count
    step = _k4_step(cfg, fused16, g)
    for _ in range(150):
        step()
    torch.cuda.synchronize()
    n_stamps = STAMP_SITES * STAMP_BLOCKS * 2
    buf = np.zeros(n_stamps + 4, np.int64)

    def read():
        torch.cuda.synchronize()
        rc = fn(buf.ctypes.data, buf.nbytes)
        if rc != 0:
            raise RuntimeError(f"cbx_k4_stamps: cudaError {rc}")
        a = buf[:n_stamps].reshape(STAMP_SITES, STAMP_BLOCKS, 2)[:, :grid].astype(np.float64)
        c0, t0, c1, t1 = (float(v) for v in buf[n_stamps:])
        span_us = (t1 - t0) / 1e3
        mhz = (c1 - c0) / span_us
        work, wait = a[..., 0], a[..., 1]
        per = {}
        for k in range(5):
            sites = [1 + 5 * layer + k for layer in range(cfg.num_layers)]
            per[f"P{k + 1}_work"] = work[sites].max(axis=1).mean() / mhz
            per[f"P{k + 1}_bar"] = wait[sites].min(axis=1).mean() / mhz
        return span_us, mhz, per

    rows = []
    for i in range(n):
        _idle()
        step()
        rows.append(read())
        cs.log("k4_stamps", build=label, mode="from_idle", step=i,
               kernel_us=f"{rows[-1][0]:.1f}", sm_mhz=f"{rows[-1][1]:.0f}",
               **{key: f"{v:.2f}" for key, v in rows[-1][2].items()})
    torch.cuda._sleep(timing.SPIN_CYCLES)
    for _ in range(n):
        step()
    queued = read()
    for mode, got in (("from_idle", rows), ("queued", [queued])):
        mean = {key: np.mean([r[2][key] for r in got]) for key in got[0][2]}
        cs.log("k4_stamps_mean", build=label, mode=mode, n=len(got),
               kernel_us=f"{np.mean([r[0] for r in got]):.1f}",
               sm_mhz=f"{np.mean([r[1] for r in got]):.0f}",
               us_per_layer=f"{sum(mean.values()):.2f}",
               **{key: f"{v:.2f}" for key, v in mean.items()}, card=repr(card))


def kernels_per_call(fn, calls: int = 20) -> float:
    """Device kernels torch.profiler records per call of fn (a capture can
    lose records: probes/timing.py)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / calls


def k1_time(card, label="shipped") -> None:
    g = torch.Generator(device="cuda").manual_seed(5)
    h, d = cs.KERNEL_H, cs.KERNEL_D
    for b in (cs.KERNEL_B, cs.KERNEL_B_BATCH):
        for lc in cs.KERNEL_LC:
            q = torch.randn((b, h, d), generator=g, device="cuda").to(torch.bfloat16)
            k, v = (torch.randn((lc, b, h, d), generator=g, device="cuda").to(torch.bfloat16)
                    for _ in range(2))
            hole = cs._batch_holes(b)
            start, pos = 4, min(lc - 1, 4 + (lc - 4) * 3 // 4)
            ms = cs._device_ms(lambda: fd.decode_attention(q, k, v, pos, start, hole), 50)
            kc = q.clone()
            per_call = {"k1": kernels_per_call(lambda: fd.decode_attention(q, k, v, pos, start,
                                                                           hole)),
                        "k1s": kernels_per_call(lambda: fd.decode_attention(
                            q, k[None], v[None], pos, start, hole, layer=0, k_cur=kc,
                            v_cur=kc))}
            cs.log("k1_time", build=label, b=b, lc=lc, pos=pos, device_ms=f"{ms:.5f}",
                   device_kernels_per_call=per_call, card=repr(card))


def int8_shapes(g) -> dict:
    """The int8 entry's timed calls, bf16 q: name -> (the int8 call, bf16 K1
    (K1s) on the same shape with the cache dequantised to bf16, the int8
    bound ms, the bf16 bound ms); INT8_SHAPES and the engine's spans (the
    smoke's timed case: SPAN_GEOMETRIES[0], drawn as phase_span_check
    draws it). Made once, so every build reads the same inputs."""
    h, d = cs.KERNEL_H, cs.KERNEL_D
    bf16 = torch.bfloat16
    shapes = {}
    for b, lc, deferred in INT8_SHAPES:
        lead = (cs.DEFER_LAYERS,) if deferred else ()
        (k, ks), (v, vs) = (cs._quantized(lead + (lc, b, h, d), g) for _ in range(2))
        kb, vb = ((x.float() * s[..., None]).to(bf16) for x, s in ((k, ks), (v, vs)))
        q, kc, vc = (torch.randn((b, h, d), generator=g, device="cuda").to(bf16)
                     for _ in range(3))
        hole = (cs._batch_holes(b) if b != cs.KERNEL_B else
                torch.tensor([[0, 0], [70, 200]], dtype=torch.int32, device="cuda"))
        start, pos = 4, min(lc - 1, 4 + (lc - 4) * 3 // 4)
        kw = dict(layer=(start + pos) % cs.DEFER_LAYERS, k_cur=kc, v_cur=vc) if deferred else {}
        shapes[f"{'k1s' if deferred else 'k1'}_b{b}_lc{lc}_pos{pos}"] = (
            partial(fd.decode_attention, q, k, v, pos, start, hole, k_scale=ks, v_scale=vs, **kw),
            partial(fd.decode_attention, q, kb, vb, pos, start, hole, **kw),
            cs._bound(*cs._int8_work(b, h, d, start, pos, hole, deferred))["bound_ms"],
            cs._bound(*cs._decode_work(b, h, d, start, pos, hole, deferred))["bound_ms"])
    p_len, lc, b, c, _, (span, hole) = cs._span_cases(np.random.default_rng(77),
                                                      *cs.SPAN_GEOMETRIES[0])
    (k, ks), (v, vs) = (cs._quantized((lc, b, h, d), g) for _ in range(2))
    kb, vb = ((x.float() * s[..., None]).to(bf16) for x, s in ((k, ks), (v, vs)))
    q = torch.randn((b, h, d), generator=g, device="cuda").to(bf16)
    keys = cs._span_keys(span, hole)
    shapes[f"k1_spans_rows{b}_lc{lc}_keys{keys}"] = (
        partial(fd.decode_attention, q, k, v, p_len + c, span=span, hole=hole, k_scale=ks,
                v_scale=vs),
        partial(fd.decode_attention, q, kb, vb, p_len + c, span=span, hole=hole),
        cs._bound(h * (2 * d + 8) * keys + 2 * 2 * b * h * d, 4 * keys * h * d)["bound_ms"],
        cs._bound(2 * h * d * (2 * keys + 2 * b), 4 * keys * h * d)["bound_ms"])
    return shapes


def k1_int8_times(card, label: str, shapes: dict, bf16: bool) -> None:
    """The int8 entry's device time at each shape (bf16: also bf16 K1 /
    K1s on it), with the int8 instance's registers and blocks an SM."""
    occ = fd.kernel_info(torch.bfloat16, int8=True)
    for name, (int8_call, bf16_call, bound, bound_bf16) in shapes.items():
        extra = ({"bf16_ms": f"{cs._device_ms(bf16_call, 50):.5f}",
                  "bf16_bound_ms": f"{bound_bf16:.5f}"} if bf16 else {})
        cs.log("k1_int8_time", build=label, shape=name,
               int8_ms=f"{cs._device_ms(int8_call, 50):.5f}", bound_ms=f"{bound:.5f}",
               **extra, registers=occ["registers"], local_bytes=occ["local_bytes"],
               blocks_per_sm=occ["blocks_per_sm"], card=repr(card))


def k1_builds(card, builds: dict, timed: bool) -> list:
    """Each K1 build (flash_decode.cu edited) checked as the shipped int8
    entry is, then (timed) every build's int8 entry in turns with the
    shipped one. Returns the labels that failed."""
    libs = build_libs(builds, K1, fd)
    failed = []
    for label, cdll in libs.items():
        with patched(fd, cdll):
            occupancy_report(label)
            try:
                cs.phase_int8_kernel_check(card)
                cs.phase_int8_kernel_check(card, deferred=True)
            except AssertionError as err:
                print(f"[build] {label} FAILED its check: {err}", flush=True)
                failed.append(label)
    ok = [label for label in libs if label not in failed]
    if timed:
        shapes = int8_shapes(torch.Generator(device="cuda").manual_seed(5))
        for label in ["shipped", *ok, "shipped", *ok[::-1], "shipped"]:
            if label == "shipped":
                k1_int8_times(card, label, shapes, bf16=True)
                continue
            with patched(fd, libs[label]):
                k1_int8_times(card, label, shapes, bf16=False)
    return failed


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--no-time", action="store_true")
    ap.add_argument("--no-k4", action="store_true", help="skip K4's checks and times")
    ap.add_argument("--builds", default="",
                    help="comma list of LABEL=DIR, DIR a copy of csrc/ with K1 or K4 edited")
    ap.add_argument("--stamps", action="store_true")
    args = ap.parse_args()
    card = cs.phase_device()
    cs.phase_build()
    ptxas_report()
    cs.phase_kernel_check(card)
    cs.phase_kernel_check(card, deferred=True)
    cs.phase_int8_kernel_check(card)
    cs.phase_int8_kernel_check(card, deferred=True)
    g = torch.Generator(device="cuda").manual_seed(99)
    k6_checks(g)
    builds = dict(item.split("=", 1) for item in args.builds.split(",") if item)
    failed = k1_builds(card, {label: src for label, src in builds.items() if differs(src, K1)},
                       not args.no_time)
    if not args.no_time:
        k1_time(card)
    if args.no_k4:
        if failed:
            raise SystemExit(f"decode check: builds failed their checks: {failed}")
        print("decode check: all cases passed", flush=True)
        return
    cfg, fused32, fused16 = full_width()
    k4_checks(cfg, fused32, fused16, g)
    builds = {label: src for label, src in builds.items() if differs(src, K4)}
    if args.stamps:
        builds.update({f"{label}+stamps": stamped_copy(Path(src), f"{label}+stamps")
                       for label, src in [("shipped", _build.CSRC), *builds.items()]})
    libs = build_libs(builds, K4, fu) if builds else {}
    for label, cdll in libs.items():
        with patched(fu, cdll):
            try:
                k4_checks(cfg, fused32, fused16, g)
            except AssertionError as err:
                print(f"[build] {label} FAILED its check: {err}", flush=True)
                failed.append(label)
    del fused32
    torch.cuda.empty_cache()
    if not args.no_time:
        from chatterbox_embed_tpu_torch.probes import decode_anatomy as pda
        res = pda.run(steps=(1024,), device_iters=30)
        for mode, key in pda.SCRIPT_KEY.items():
            for _, tag in pda.POSITIONS:
                cs.log("probe", kernel="decode_anatomy", mode=mode, script_key=f"{key}_{tag}",
                       device_us=f"{res[f'{key}_{tag}_device_us']:.3f}",
                       cold_device_us=f"{res[f'{key}_{tag}_cold_device_us']:.3f}",
                       card=repr(card))
    timed = [label for label in libs if not label.endswith("+stamps") and label not in failed]
    if not args.no_time or timed:
        for label in ["shipped", *timed, "shipped"] if timed else ["shipped"]:
            if label == "shipped":
                cs.fused_times(fused16, cfg, card, label)
                continue
            with patched(fu, libs[label]):
                cs.fused_times(fused16, cfg, card, label)
    for label, cdll in libs.items():
        if label.endswith("+stamps") and label not in failed:
            with patched(fu, cdll):
                k4_stamps(cfg, fused16, g, card, label, cdll)
    if failed:
        raise SystemExit(f"decode check: builds failed their checks: {failed}")
    print("decode check: all cases passed", flush=True)


if __name__ == "__main__":
    main()
