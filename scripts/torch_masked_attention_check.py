"""Build-and-check run of the port's masked-attention kernels (K2
`rel_attention`, K3 `flash_attention` and its backward K3b) on one CUDA
card (an H100), shorter than the smoke run and more talkative about the
kernels:

    python3 scripts/torch_masked_attention_check.py [--no-time]

1. compiles `csrc/rel_attention.cu`, `csrc/flash_attention.cu` and
   `csrc/flash_attention_bwd.cu` once more with `-Xptxas -v` beside the
   normal build and prints, per kernel, the registers, spills and any
   ptxas warning (a serialised wgmma), and how many tensor-core
   instructions (HGMMA) the disassembly holds (PERF.md records each
   kernel's earlier counts: compare against them);
2. runs every case below and prints each one's error against the plain
   version, and where the largest error sits, without stopping at the first
   failure: one-hot rows, one valid key a tile, dead tiles, T = 1 / 40 / 64
   / 65 / 406 / 812, q.k widths 64, 128 and 576; then K3b (dq, dk, dv from
   K3's lse) in bf16 and fp32 on one-hot rows, all-valid, dead-tile and
   ragged masks (a row without a valid key must get exact zeros) at T = 1 /
   40 / 64 / 65 / 130 / 812;
3. unless `--no-time`, runs the smoke's `phase_attention_check` (all its
   checks, then the times of the kernels and of the library's call on a
   ragged and an all-valid mask, and K3b's).

Exits non-zero if a case failed. Needs CUDA and nvcc.
"""
from __future__ import annotations

import re
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from chatterbox_embed_tpu_torch.kernels import _build  # noqa: E402
from chatterbox_embed_tpu_torch.kernels import flash_attention as fa  # noqa: E402
from chatterbox_embed_tpu_torch.kernels import flash_attention_bwd as fb  # noqa: E402
from chatterbox_embed_tpu_torch.kernels import masked_attention as ma  # noqa: E402
from chatterbox_embed_tpu_torch.kernels import rel_attention as ra  # noqa: E402

OUT = _build.BUILD_ROOT / "ptxas"


def ptxas_report(sources) -> None:
    """What ptxas says of each kernel of `sources`, and the tensor-core
    instruction count."""
    nvcc = _build.find_nvcc()
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = []
    for src in sources:
        lib = OUT / f"ptxas_{src.stem}.so"
        cmd = [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(lib), str(src)]
        jobs.append((src, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
    for src, lib, proc in jobs:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            print(text[-6000:])
            raise SystemExit(f"nvcc failed on {src.name}")
        name = None
        for line in text.splitlines():
            found = re.search(r"Compiling entry function '(\S+)'", line)
            if found:
                name = found.group(1)
            elif "warning" in line.lower() or "C75" in line:
                print(f"[ptxas] {src.stem} WARNING {line.strip()[:1000]}")
            elif "registers" in line or "spill" in line:
                print(f"[ptxas] {src.stem} {(name or '')[:90]}: {line.strip()[:200]}")
        dump = Path(nvcc).with_name("cuobjdump")
        if dump.is_file():
            sass = subprocess.run([str(dump), "-sass", str(lib)], capture_output=True,
                                  text=True).stdout
            print(f"[sass] {src.stem} HGMMA={len(re.findall(r'HGMMA', sass))} "
                  f"FFMA={len(re.findall(r'FFMA', sass))} "
                  f"LDGSTS={len(re.findall(r'LDGSTS', sass))}")
        lib.unlink()


def run_cases() -> int:
    g = torch.Generator(device="cuda").manual_seed(99)
    scale = 0.125
    failed = 0
    bf16 = torch.bfloat16
    kernels = {
        "flash_attention": (fa.flash_attention, fa.flash_attention_reference, (64,)),
        "rel_attention": (lambda q, k, v, m: ra.rel_attention(q, k, v, m, scale),
                          lambda q, k, v, m: ra.rel_attention_reference(q, k, v, m, scale),
                          (576, 128, 64)),
    }
    for name, (kernel, plain, widths) in kernels.items():
        empty_row = name == "rel_attention"
        for da in widths:
            cases = []
            for t in (128, 40):
                q, k, v = cs._onehot_case(8, t, da, g)
                cases.append((f"onehot t={t}", q, k, v, torch.ones((8, t), dtype=torch.bool,
                                                                   device="cuda")))
            for t in (64, 1, 40, 65, 406, 812):
                q, k, v = (torch.randn((8, t, cs.ATT_H, w), generator=g, device="cuda").to(bf16)
                           for w in (da, da, cs.ATT_D))
                cases.append((f"all_valid t={t}", q, k, v,
                              torch.ones((8, t), dtype=torch.bool, device="cuda")))
                if t > 1:
                    cases.append((f"dead_tiles t={t}", q, k, v,
                                  cs._dead_tile_valid(8, t, g, empty_row)))
                    cases.append((f"ragged t={t}", q, k, v,
                                  cs._ragged_valid(8, t, g, empty_row)))
            for label, q, k, v, valid in cases:
                ref = plain(q, k, v, valid).float()
                out = kernel(q, k, v, valid).float()
                torch.cuda.synchronize()
                rel = (out - ref).abs() / ref.abs().clamp_min(1.0)
                if empty_row and not bool(valid[2].any()):
                    rel[2] = out[2].abs() * 1e9          # that row must be exactly 0
                bad = ~torch.isfinite(out)
                rel = torch.where(bad, torch.full_like(rel, float("inf")), rel)
                worst = rel.max().item()
                ok = worst <= cs.ATT_TOL[bf16]
                where = [int(i) for i in torch.unravel_index(rel.argmax(), rel.shape)]
                share = (rel > cs.ATT_TOL[bf16]).float().mean().item()
                print(f"[case] {name} da={da} {label}: "
                      f"{'ok' if ok else 'FAIL'} err={worst:.3e} at(b,t,h,d)={where} "
                      f"share_over_limit={share:.4f}", flush=True)
                if not ok:
                    failed += 1
                    walk = ma.tiled_reference(q, k, v, valid, scale).float()
                    print(f"        plain tile walk against plain: "
                          f"{(walk - ref).abs().max().item():.3e}; out at worst "
                          f"{out[tuple(where)].item():.4f} ref {ref[tuple(where)].item():.4f}")
    return failed


def run_bwd_cases() -> int:
    """K3b against the plain backward (with the plain lse) on every case;
    bf16 errors over max(|ref|, rms(ref)) against BWD_TOL_BF16, fp32 over
    max(1, |ref|) against ATT_TOL."""
    g = torch.Generator(device="cuda").manual_seed(77)
    failed = 0
    for dtype in (torch.bfloat16, torch.float32):
        cases = []
        for t in (128, 40):
            q, k, v = cs._onehot_case(8, t, cs.ATT_D, g)
            cases.append((f"onehot t={t}", q, k, v,
                          cs._dead_tile_valid(8, t, g, empty_row=True)))
        for t in (1, 40, 64, 65, 130, 812):
            q, k, v = (torch.randn((8, t, cs.ATT_H, cs.ATT_D), generator=g, device="cuda")
                       for _ in range(3))
            cases.append((f"all_valid t={t}", q, k, v,
                          torch.ones((8, t), dtype=torch.bool, device="cuda")))
            if t > 1:
                cases.append((f"dead_tiles t={t}", q, k, v, cs._dead_tile_valid(8, t, g, True)))
                cases.append((f"ragged t={t}", q, k, v, cs._ragged_valid(8, t, g, True)))
        for label, q, k, v, valid in cases:
            q, k, v = (x.to(dtype) for x in (q, k, v))
            dout = torch.randn(q.shape, generator=g, device="cuda").to(dtype)
            out, lse = fa.flash_attention_with_lse(q, k, v, valid)
            ref = fb.flash_attention_backward_reference(q, k, v, valid, out, dout)
            got = fb.flash_attention_backward(q, k, v, valid, out, dout, lse)
            torch.cuda.synchronize()
            empty = ~valid.any(dim=1)
            for name, x, r in zip(("dq", "dk", "dv"), got, ref):
                x, r = x.float(), r.float()
                # bf16: over max(|ref|, rms(ref), 1e-3); the floor keeps a
                # gradient that is 0 in exact arithmetic (dq, dk at T = 1,
                # rounding noise of ~1e-7 on both sides) from dividing by ~0
                floor = max(r.pow(2).mean().sqrt().item(), 1e-3) \
                    if dtype == torch.bfloat16 else 1.0
                rel = (x - r).abs() / r.abs().clamp_min(floor)
                rel = torch.where(torch.isfinite(x), rel, torch.full_like(rel, float("inf")))
                if empty.any():
                    rel[empty] = x[empty].abs() * 1e9        # exactly 0 there
                limit = cs.BWD_TOL_BF16 if dtype == torch.bfloat16 else cs.ATT_TOL[dtype]
                worst = rel.max().item()
                ok = worst <= limit
                where = [int(i) for i in torch.unravel_index(rel.argmax(), rel.shape)]
                print(f"[case] flash_attention_bwd {str(dtype)[6:]} {name} {label}: "
                      f"{'ok' if ok else 'FAIL'} err={worst:.3e} at(b,t,h,d)={where} "
                      f"got={x[tuple(where)].item():.5f} ref={r[tuple(where)].item():.5f}",
                      flush=True)
                failed += not ok
    return failed


if __name__ == "__main__":
    t0 = time.time()
    card = cs.phase_device()
    ptxas_report([ra.SOURCE, fa.SOURCE, fb.SOURCE])
    _build.build_all([ra.SOURCE, fa.SOURCE, fb.SOURCE])
    print(f"[build] seconds={time.time() - t0:.1f}", flush=True)
    failed = run_cases() + run_bwd_cases()
    print(f"[cases] failed={failed} seconds={time.time() - t0:.1f}", flush=True)
    if failed:
        raise SystemExit(1)
    if "--no-time" not in sys.argv:
        res = cs.phase_attention_check(card)
        for name, r in res.items():
            print(f"[result] {name} " + " ".join(
                f"{key}={val:.5f}" if isinstance(val, float) else f"{key}={val}"
                for key, val in r["timing"].items()), flush=True)
    print(f"[done] seconds={time.time() - t0:.1f} card={card!r}")
