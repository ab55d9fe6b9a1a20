"""The DeepSeek-V2 cell (`tts-dsv2-backlog`: its configuration, driver,
weights, check and metrics) on the CPU at a tiny size: the reference agrees
with the port, the control and planted faults come out not correct, the
yardstick's arithmetic is right by hand, and the new files are found by
the harness as files. On a card, the control at the cell's own size."""
from __future__ import annotations

import json
import math
from pathlib import Path

import pytest
import torch

import tiny
from portbench import run
from portbench.lib import model, model_dsv2, work, work_dsv2

SEED = 2 ** 31 + 4242
CELL = "tts-dsv2-backlog"
HERE = Path(__file__).resolve().parent.parent


def _config() -> dict:
    """The configuration at a tiny size that keeps every mechanism: 3 layers
    (1 dense, 2 MoE), 8 experts of which 2 a token, 2 shared, YaRN whose
    ramp bites inside the positions used; S3Gen as tiny.py cuts it."""
    cfg = json.loads((HERE / "configs" / "chatterbox-t3-dsv2-lite.json").read_text())
    cfg["dtype"] = "float32"
    cfg["t3"]["backbone"].update(
        hidden_size=64, num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=4,
        kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
        intermediate_size=96, moe_intermediate_size=32, n_routed_experts=8, n_shared_experts=2,
        num_experts_per_tok=2,
        rope_scaling=dict(cfg["t3"]["backbone"]["rope_scaling"],
                          original_max_position_embeddings=64))
    small = tiny.config()
    cfg["s3gen"], cfg["voice"] = small["s3gen"], small["voice"]
    return cfg


def _run(seconds=3.0, judge=None, device="cpu", small=True):
    cell = tiny.cell(CELL) if small else None
    cfg = _config() if small else None
    orig = run.Ctx.judge
    if judge is not None:
        run.Ctx.judge = judge
    try:
        return run.run_cell(CELL, SEED, seconds, False, device=device, cell=cell, cfg=cfg,
                            manifest=tiny.manifest())
    finally:
        run.Ctx.judge = orig


def test_the_configuration_is_the_published_one():
    cfg = json.loads((HERE / "configs" / "chatterbox-t3-dsv2-lite.json").read_text())
    backbone = cfg["t3"]["backbone"]
    for k, v in backbone.items():
        assert cfg[k] == v, k
    assert cfg["reduced"] == ["vocab_size"] and cfg["published_vocab_size"] == 102400
    pc = model_dsv2.port_config(cfg)
    n = sum(t.numel() for _, t in model._leaves(model_dsv2.t3_layout(cfg)["llama"]))
    assert n == 15_287_053_824                      # the backbone whole, 30.6 GB in bf16
    assert (pc.t3.llama.num_layers, pc.t3.llama.n_routed_experts) == (27, 64)
    assert work_dsv2.active_params(backbone) == 2_241_593_344


def test_k7_work_and_t3_flops_by_hand():
    nbytes, ops = work_dsv2.k7_work(192, 60, 2048, 1408)
    assert nbytes == 60 * 3 * 2048 * 1408 * 2 + 192 * 2048 * 6
    assert ops == 6 * 2048 * 1408 * 192
    assert work.bound_s(nbytes, ops) == pytest.approx(nbytes / 3.35e12)
    t3c = _config()["t3"]
    per_pos = 2 * work_dsv2.active_params(t3c["backbone"])
    att = lambda ctx: 2 * 3 * 4 * (16 + 8 + 16) * ctx
    head = 2 * 64 * t3c["speech_tokens_dict_size"]
    want = 2 * (2 * per_pos + att(1) + att(2) + head + per_pos + att(3) + head)
    assert work_dsv2.t3_flops(t3c, context=2, tokens=1) == want


def test_weights_are_drawn_leaf_by_leaf_and_the_reference_gets_the_same_values():
    cfg = _config()
    served = model_dsv2.make_t3(cfg, 7, "cpu")
    again = model_dsv2.make_t3(cfg, 7, "cpu", served=False, layers=False)
    layer = model_dsv2.reference_layer(cfg, 7, "cpu", 2)
    assert torch.equal(served["llama"]["layers"][2]["experts"]["down"]["w"],
                       layer["experts"]["down"]["w"])
    assert torch.equal(served["speech_head"]["w"], again["speech_head"]["w"])
    assert "layers" not in again["llama"]
    other = model_dsv2.make_t3(cfg, 8, "cpu")
    assert not torch.equal(other["llama"]["layers"][1]["q"]["w"],
                           served["llama"]["layers"][1]["q"]["w"])
    w = served["llama"]["layers"][1]["experts"]["gate"]["w"]
    # uniform at the fan-in 64 spread, rounded to bf16
    assert w.abs().max() <= 1.01 * math.sqrt(3.0 / 64) and w.std() > 0.5 * math.sqrt(1.0 / 64)


def test_reference_agrees_with_the_port():
    out, lines = _run()
    assert out["correct"] is True, lines
    assert out["attempted"] > 0
    for k, v in out["checks"].items():
        assert v["value"] <= (0.05 if k == "hift_vs_bf16" else 1e-4), (k, v)


def test_a_request_decoded_again_is_judged_by_the_draws_it_was_served_from(monkeypatch):
    """Every request decoded a second time (the server's minimum of speech
    tokens out of reach): each is served from the retry's draws, whose seed
    is not the request's, and the check replays those."""
    from chatterbox_embed_tpu_torch.serving import continuous
    monkeypatch.setattr(continuous, "MIN_TOKENS", 10 ** 6)
    out, lines = _run()
    again = [int(x.split("; ")[-1].split()[0]) for x in lines if "second decode" in x]
    assert again and again[0] > 0, lines
    assert out["correct"] is True, lines
    assert out["checks"]["t3_gap"]["value"] <= 1e-4, lines


def test_control_is_not_correct():
    out, _ = _run(judge=lambda self, numbers_of: numbers_of("fp8"))
    assert out["correct"] is False


def _dropped_expert(monkeypatch):
    """Each row's first chosen expert computed and routed, but its output
    left out of the sum (its weight zeroed)."""
    from chatterbox_embed_tpu_torch.models import deepseek_v2
    orig = deepseek_v2.route

    def dropped(lp, x, cfg):
        ids, w = orig(lp, x, cfg)
        return ids, torch.cat([torch.zeros_like(w[:, :1]), w[:, 1:]], dim=1)

    monkeypatch.setattr(deepseek_v2, "route", dropped)


def _altered_route(monkeypatch):
    """Every third row's last expert swapped for the router's least liked."""
    from chatterbox_embed_tpu_torch.models import deepseek_v2
    orig = deepseek_v2.route

    def altered(lp, x, cfg):
        ids, w = orig(lp, x, cfg)
        worst = (x.float() @ lp["router"]["w"].float()).argmin(-1)
        ids = ids.clone()
        ids[::3, -1] = worst[::3]
        return ids, w

    monkeypatch.setattr(deepseek_v2, "route", altered)


def _no_mscale(monkeypatch):
    """The softmax scale without YaRN's mscale squared."""
    from chatterbox_embed_tpu_torch.models import deepseek_v2
    monkeypatch.setattr(deepseek_v2, "softmax_scale", lambda cfg: cfg.q_head_dim ** -0.5)


@pytest.mark.parametrize("fault,broken", [(_dropped_expert, "t3_gap"),
                                          (_altered_route, "route_gap"),
                                          (_no_mscale, "t3_gap")],
                         ids=["dropped_expert", "altered_route", "no_mscale"])
def test_a_planted_fault_is_not_correct(monkeypatch, fault, broken):
    fault(monkeypatch)
    out, _ = _run()
    assert out["correct"] is False
    assert out["checks"][broken]["value"] > out["checks"][broken]["limit"]


def test_the_new_files_are_found_as_files():
    m = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    entry, e2e, layer = run.manifest_entries(m, CELL)
    assert entry["config"] == "chatterbox-t3-dsv2-lite"
    assert {x["name"] for x in e2e} == {"audio_s_per_s", "setup_s"}
    assert {x["name"] for x in layer} == {"mfu", "device_idle", "t3_step_ms.backlog",
                                          "vocode_share.backlog", "k3_roofline", "moe_roofline",
                                          "moe_share.dsv2"}
    for x in layer:
        assert callable(run.metric_reader(x["name"]))
    cell = run.load_json(HERE / "workloads" / f"{CELL}.json")
    assert (HERE / "drivers" / f"{cell['driver']}.py").is_file()
    backlog = run.load_json(HERE / "workloads" / "tts-backlog.json")
    assert cell["traffic"] == backlog["traffic"] and cell["server"] == backlog["server"]


def test_the_metrics_read_the_counters_and_the_trace():
    from types import SimpleNamespace
    cfg = json.loads((HERE / "configs" / "chatterbox-t3-dsv2-lite.json").read_text())
    counters = {"profiled.moe.calls": 26, "profiled.moe.assignments": 26 * 192,
                "profiled.moe.experts_touched": 26 * 60, "t_decode_s": 1.5, "steps": 100}
    trace = {"by_name": {"void (anonymous namespace)::moe_kernel<true>(...)": 0.010,
                         "void (anonymous namespace)::moe_kernel<false>(...)": 0.005,
                         "other": 0.1}, "busy_s": 0.5, "window_s": 1.0}
    r = SimpleNamespace(counters=counters, trace=trace, cfg=cfg, window_s=1.0)
    bound = 26 * (60 * 3 * 2048 * 1408 * 2 + 192 * 2048 * 6) / 3.35e12
    assert run.metric_reader("moe_roofline")(r) == pytest.approx(100 * bound / 0.015)
    assert run.metric_reader("moe_share.dsv2")(r) == pytest.approx(100 * 0.015 / 0.5)
    assert run.metric_reader("t3_step_ms.backlog")(r) == pytest.approx(15.0)
    empty = SimpleNamespace(counters={}, trace={}, cfg=cfg, window_s=1.0)
    for name in ("moe_roofline", "moe_share.dsv2", "t3_step_ms.backlog"):
        assert run.metric_reader(name)(empty) is None


@pytest.mark.card
def test_control_at_the_cells_size_is_not_correct(card):
    out, _ = _run(seconds=10.0, judge=lambda self, numbers_of: numbers_of("fp8"), device=card,
                  small=False)
    assert out["correct"] is False
