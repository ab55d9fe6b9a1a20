"""A tiny configuration and tiny cells for running the harness on the
CPU: the configurations' keys with small widths, the cells' drivers with
few slots and short requests."""
from __future__ import annotations

import json
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
ROOT = HERE.parent


def config(name: str = "chatterbox-tts") -> dict:
    cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
    cfg["dtype"] = "float32"
    cfg["t3"]["llama"].update(hidden_size=64, intermediate_size=128, num_layers=2, num_heads=4,
                              num_kv_heads=4, head_dim=16)
    fl = cfg["s3gen"]["flow"]
    fl["input_size"] = 32
    fl["encoder"].update(input_size=32, output_size=32, attention_heads=2, linear_units=64,
                         num_blocks=1, num_up_blocks=1)
    fl["decoder"].update(channels=16, attention_head_dim=8, num_heads=2, n_blocks=1,
                         num_mid_blocks=2, time_embed_dim=32)
    cfg["s3gen"]["hift"].update(base_channels=16, f0_cond_channels=16)
    cfg["s3gen"]["tokenizer"].update(n_state=32, n_heads=2, n_layers=1)
    cfg["voice"].update(s3gen_prompt_tokens=20)
    return cfg


def cell(name: str) -> dict:
    path = HERE / "workloads" / f"{name}.json"
    c = json.loads(path.read_text())
    if "server" in c:
        c["server"].update(slots=2, text_bucket=64, max_new_tokens=40, block=8, vocode_batch=2)
        c["traffic"].update(tokens={"dist": "log_uniform", "lo": 10, "hi": 30}, max_chars=40,
                            depth_per_slot=2)
    else:
        c["traffic"].update(tokens={"dist": "uniform", "lo": 6, "hi": 40})
    return c


def manifest() -> dict:
    """BENCHMARK.json, with an entry for each cell file that it does not
    name (and for that cell's configuration), so that the drivers and
    checks of cells kept out of the manifest still run here."""
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"] for w in m["workloads"]}
    configs = {c["name"] for c in m["configs"]}
    for path in sorted((HERE / "workloads").glob("*.json")):
        if path.stem in cells:
            continue
        name = json.loads(path.read_text())["config"]
        m["workloads"].append({"name": path.stem, "config": name, "traffic": path.stem,
                               "chips": 1, "why": "a cell file outside the manifest"})
        if name not in configs:
            configs.add(name)
            m["configs"].append({"name": name, "source": "", "reduced": [],
                                 "file": f"portbench/configs/{name}.json",
                                 "why": "a configuration outside the manifest"})
    return m
