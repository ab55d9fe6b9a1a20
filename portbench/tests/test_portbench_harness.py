"""The harness's arithmetic, its manifest, its guard and its data-driven
discovery, on the CPU."""
from __future__ import annotations

import json
import math
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import run
from portbench.lib import stats, traffic, work

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def _tts_traffic():
    return json.loads((BENCH / "workloads" / "tts-backlog.json").read_text())["traffic"]


def test_requests_are_the_seeds_alone():
    tr = _tts_traffic()
    a = [traffic.request(tr, 2 ** 31 + 5, k) for k in range(40)]
    b = [traffic.request(tr, 2 ** 31 + 5, k) for k in range(40)]
    assert a == b
    c = [traffic.request(tr, 2 ** 31 + 6, k) for k in range(40)]
    assert [r.tokens for r in a] != [r.tokens for r in c]


def test_every_seed_brings_the_same_sizes_in_another_order():
    tr = _tts_traffic()
    blocks = [sorted(traffic.request(tr, s, k).tokens for k in range(traffic.BLOCK))
              for s in (1, 2, 3 ** 20)]
    assert blocks[0] == blocks[1] == blocks[2]
    assert min(blocks[0]) >= 100 and max(blocks[0]) <= 600


def test_poisson_schedule_is_the_seeds_and_holds_its_rate():
    tr = {"arrivals": "poisson", "rate": 2.0}
    a = traffic.schedule(tr, 11, 400.0)
    assert a == traffic.schedule(tr, 11, 400.0)
    assert a != traffic.schedule(tr, 12, 400.0)
    assert all(x < y for x, y in zip(a, a[1:]))
    assert abs(len(a) / 400.0 - 2.0) < 0.2


def test_texts_fit_the_bucket():
    tr = _tts_traffic()
    for k in range(64):
        r = traffic.request(tr, 9, k)
        assert 8 <= len(r.text) <= tr["max_chars"] and r.text.endswith(".")


@pytest.mark.parametrize("values,q,want", [
    ([1.0, 2.0, 3.0, math.inf], 90, math.inf),
    ([1.0] * 9 + [math.inf], 90, 1.0),
    ([5.0, 1.0, 3.0, 2.0, 4.0], 50, 3.0),
    ([], 90, math.inf),
])
def test_percentile_counts_unfinished_requests_as_misses(values, q, want):
    assert stats.percentile(values, q) == want


def test_rate_is_the_work_in_the_window_over_the_whole_window():
    done = [(0.5, 9.0), (2.0, 3.0), (9.0, 4.0), (10.5, 100.0)]
    # work handed back before the window or after its end counts for nothing,
    # and a stall at either end stays in the denominator
    assert stats.rate(done, 1.0, 10.0) == pytest.approx(7.0 / 9.0)


def test_decode_attention_work_by_hand():
    # row 0 attends [2, 9] minus [4, 6): 6 keys; row 1 is empty ([1, 0])
    nbytes, ops = work.decode_attention_work([(2, 9), (1, 0)], [(4, 6), (0, 0)], heads=2,
                                             head_dim=4, itemsize=2)
    assert ops == 4 * 6 * 2 * 4
    assert nbytes == 2 * 2 * 4 * (2 * 6 + 2 * 2)


def test_flash_attention_work_by_hand():
    nbytes, ops = work.flash_attention_work(2, 10, 3, 8, valid_keys=15, itemsize=2)
    assert ops == 4 * 3 * 8 * 10 * 15
    assert nbytes == 2 * 4 * (2 * 10 * 3 * 8) + 2 * 10
    assert work.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert work.bound_s(0, 989e12) == pytest.approx(1.0)


def test_t3_flops_by_hand():
    t3 = {"llama": {"hidden_size": 4, "intermediate_size": 8, "num_layers": 1, "num_heads": 2,
                    "head_dim": 2}, "speech_tokens_dict_size": 10}
    per_pos = 2 * (4 * 4 * 4 + 3 * 4 * 8)
    att = lambda ctx: 4 * 4 * ctx
    head = 2 * 4 * 10
    prefill = 3 * per_pos + att(1) + att(2) + att(3) + head
    decode = (per_pos + att(4) + head) + (per_pos + att(5) + head)
    assert work.t3_flops(t3, context=3, tokens=2) == 2 * (prefill + decode)


def test_s3gen_flops_grow_with_the_tokens():
    cfg = json.loads((BENCH / "configs" / "chatterbox-tts.json").read_text())
    a = work.s3gen_flops(cfg["s3gen"], 250, 100)
    b = work.s3gen_flops(cfg["s3gen"], 250, 200)
    assert 0 < a < b


@pytest.mark.parametrize("found", ["jax", "jaxlib", "flax", "chatterbox_embed_tpu"])
def test_import_guard_rejects_jax_and_the_jax_package(monkeypatch, found):
    monkeypatch.setitem(sys.modules, found + ".sub", object())
    assert found in run.forbidden_modules()


def test_import_guard_accepts_the_port():
    import chatterbox_embed_tpu_torch  # noqa: F401
    assert "chatterbox_embed_tpu_torch" not in run.forbidden_modules()


def test_manifest_keeps_to_the_contract():
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert 1 <= m["run_seconds"] <= 51 and isinstance(m["run_seconds"], int)
    names = set()
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and (ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
        names.add(c["name"])
    cells = set()
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["config"] in names
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200 and "\n" not in w["why"]
        assert (BENCH / "workloads" / f"{w['traffic']}.json").is_file()
        cells.add(w["name"])
    e2e = {e["name"] for e in m["end_to_end"]}
    assert "setup_s" in e2e
    for e in m["end_to_end"]:
        assert set(e) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert NAME.match(e["name"]) and UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        assert e["source"] in ("host_clock", "device_trace") and 0.01 <= e["bound"] <= 0.25
    for p in m["per_layer"]:
        assert set(p) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert NAME.match(p["name"]) and UNIT.match(p["unit"]) and p["moves"] in e2e
        assert set(p["workloads"]) <= cells
        assert (BENCH / "metrics" / f"{p['name']}.py").is_file()
    every = [x["name"] for x in m["configs"] + m["workloads"] + m["end_to_end"] + m["per_layer"]]
    assert len(every) == len(set(every))
    assert len(json.dumps(m).encode()) <= 64 * 1024


def test_reference_imports_nothing_of_the_program_or_jax():
    pat = re.compile(r"^\s*(from|import)\s+(\S+)", re.M)
    for path in (BENCH / "reference").glob("*.py"):
        for _, mod in pat.findall(path.read_text()):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "chatterbox_embed_tpu",
                               "chatterbox_embed_tpu_torch", "portbench"), (path, mod)


def test_a_cell_config_and_metric_dropped_in_as_files_are_found(tmp_path):
    """A copy of the benchmark with one more configuration, cell and metric,
    each a new file, and a manifest that names them: the run finds all
    three by name, with no file of the copy edited."""
    shutil.copytree(BENCH, tmp_path / "portbench", ignore=shutil.ignore_patterns("_cache"))
    os.symlink(ROOT / "chatterbox_embed_tpu_torch", tmp_path / "chatterbox_embed_tpu_torch")
    sys.path.insert(0, str(BENCH / "tests"))
    import tiny
    cfg = tiny.config()
    (tmp_path / "portbench" / "configs" / "dummy-tiny.json").write_text(json.dumps(cfg))
    cell = tiny.cell("tts-backlog")
    cell["config"] = "dummy-tiny"
    (tmp_path / "portbench" / "workloads" / "dummy.json").write_text(json.dumps(cell))
    (tmp_path / "portbench" / "metrics" / "dummy_steps.py").write_text(
        "def read(run):\n    return float(run.counters['steps'])\n")
    m = tiny.manifest()
    m["configs"].append({"name": "dummy-tiny", "source": "https://example.org/dummy",
                         "file": "portbench/configs/dummy-tiny.json", "reduced": [], "why": "a test"})
    m["workloads"] = [{"name": "dummy", "config": "dummy-tiny", "traffic": "dummy", "chips": 1,
                       "why": "a test"}]
    m["per_layer"] = [{"name": "dummy_steps", "unit": "steps", "better": "higher",
                       "source": "program_counter", "layer": "engine", "moves": "audio_s_per_s",
                       "workloads": ["dummy"]}]
    for e in m["end_to_end"]:
        e.pop("workloads", None)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    code = ("import sys, json; sys.path.insert(0, '.'); from portbench import run; "
            "out, lines = run.run_cell('dummy', 5, 2.0, True, device='cpu'); "
            "print(json.dumps(out))")
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["metrics"]["dummy_steps"]["value"] > 0
    assert out["correct"] is True


def test_a_run_without_the_program_prints_nothing_and_fails(tmp_path):
    shutil.copytree(BENCH, tmp_path / "portbench", ignore=shutil.ignore_patterns("_cache"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", "tts-backlog",
                           "--seed", "2147483659", "--seconds", "1", "--trace", "0"],
                          cwd=tmp_path, capture_output=True, text=True, timeout=600,
                          env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
