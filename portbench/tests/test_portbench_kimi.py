"""The Kimi-Linear cell (`tts-kimi-backlog`: its configuration, driver,
weights, check and metrics) on the CPU at a tiny size: the configuration
is the catalog's, the traffic tts-backlog's, the reference agrees with the
port, the control and planted faults come out not correct, the
yardstick's arithmetic is right by hand, and the new files are found by
the harness as files. On a card, at the cell's own size, the control and
the KDA state kept in bf16."""
from __future__ import annotations

import json
import math
from pathlib import Path

import pytest
import torch

import tiny
from portbench import run
from portbench.lib import model, model_kimi, work, work_kimi

SEED = 2 ** 31 + 5151
CELL = "tts-kimi-backlog"
HERE = Path(__file__).resolve().parent.parent
# the published config.json (moonshotai/Kimi-Linear-48B-A3B-Instruct), as the model catalog reads it
PUBLISHED = {
    "first_k_dense_replace": 1,
    "head_dim": 72,
    "hidden_act": "silu",
    "hidden_size": 2304,
    "intermediate_size": 9216,
    "kv_lora_rank": 512,
    "linear_attn_config": {"full_attn_layers": [4, 8, 12, 16, 20, 24, 27], "head_dim": 128,
                           "kda_layers": [1, 2, 3, 5, 6, 7, 9, 10, 11, 13, 14, 15, 17, 18, 19,
                                          21, 22, 23, 25, 26],
                           "num_heads": 32, "short_conv_kernel_size": 4},
    "mla_use_nope": True,
    "model_max_length": 1048576,
    "model_type": "kimi_linear",
    "moe_intermediate_size": 1024,
    "moe_layer_freq": 1,
    "moe_renormalize": True,
    "moe_router_activation_func": "sigmoid",
    "num_attention_heads": 32,
    "num_expert_group": 1,
    "num_experts": 256,
    "num_experts_per_token": 8,
    "num_hidden_layers": 27,
    "num_key_value_heads": 32,
    "num_nextn_predict_layers": 0,
    "num_shared_experts": 1,
    "q_lora_rank": None,
    "qk_nope_head_dim": 128,
    "qk_rope_head_dim": 64,
    "rms_norm_eps": 1e-05,
    "rope_scaling": None,
    "rope_theta": 10000,
    "routed_scaling_factor": 2.446,
    "tie_word_embeddings": False,
    "topk_group": 1,
    "use_grouped_topk": True,
    "v_head_dim": 128,
    "vocab_size": 163840,
}


def _config() -> dict:
    """The configuration at a tiny size that keeps every mechanism: 4
    layers (layer 0 dense; KDA at 1, 2 and MLA at 3, 4 of the 1-indexed
    count, so the last is MLA as published), KDA 4 heads of 16, MLA 4
    heads, 16 routed experts of which 8 held, top 4, 1 shared; S3Gen as
    tiny.py cuts it."""
    cfg = json.loads((HERE / "configs" / "chatterbox-t3-kimi-linear.json").read_text())
    cfg["dtype"] = "float32"
    cfg["t3"]["backbone"].update(
        hidden_size=64, num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=4,
        kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
        intermediate_size=96, moe_intermediate_size=32, num_experts=8, published_num_experts=16,
        num_experts_per_token=4,
        linear_attn_config={"kda_layers": [1, 2], "full_attn_layers": [3, 4], "num_heads": 4,
                            "head_dim": 16, "short_conv_kernel_size": 4})
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


def test_the_configuration_is_the_catalogs_with_its_cut():
    cfg = json.loads((HERE / "configs" / "chatterbox-t3-kimi-linear.json").read_text())
    assert cfg["reduced"] == ["num_experts", "vocab_size"]
    assert (cfg["published_num_experts"], cfg["published_vocab_size"]) == (256, 163840)
    assert cfg["source"] == ("https://huggingface.co/moonshotai/Kimi-Linear-48B-A3B-Instruct/"
                             "blob/main/config.json")
    for k, v in PUBLISHED.items():
        if k not in cfg["reduced"]:
            assert cfg[k] == v, k
    assert cfg["num_experts"] == 32 and PUBLISHED["num_experts"] == 256
    backbone = cfg["t3"]["backbone"]
    for k, v in backbone.items():
        if k != "published_num_experts":
            assert cfg[k] == v, k
    pc = model_kimi.port_config(cfg)
    lc = pc.t3.llama
    assert (lc.num_layers, lc.n_routed_experts, lc.experts_held) == (27, 256, (0, 32))
    assert lc.kinds.count("kda") == 20 and lc.kinds[26] == "mla"
    n = sum(t.numel() for _, t in model._leaves(model_kimi.t3_layout(cfg)["llama"]))
    assert 7.0e9 < n < 7.3e9                        # 32 experts of 256 held: ~14.3 GB in bf16


def test_the_traffic_is_tts_backlogs():
    cell = run.load_json(HERE / "workloads" / f"{CELL}.json")
    backlog = run.load_json(HERE / "workloads" / "tts-backlog.json")
    assert cell["traffic"] == backlog["traffic"] and cell["server"] == backlog["server"]
    assert cell["profile_seconds"] == backlog["profile_seconds"]


def test_k9_work_active_params_and_t3_flops_by_hand():
    nbytes, ops = work_kimi.k9_work(64, 1024, 1024, 32, 128, 128)
    assert nbytes == 2048 * 128 * 128 * 4 + 64 * 32 * (3 * 128 + 2 * 128 + 1) * 4
    assert ops == 7 * 64 * 32 * 128 * 128
    assert work.bound_s(nbytes, ops, "fp32") == pytest.approx(nbytes / 3.35e12)
    cb = _config()["t3"]["backbone"]
    kda = 4 * 64 * 64 + 2 * (64 * 16 + 16 * 64) + 64 * 4 + 4 * 3 * 64
    mla = 64 * 4 * 24 + 64 * 40 + 32 * 4 * 32 + 4 * 16 * 64
    moe = 64 * 16 + 4 * 3 * 64 * 32 * 8 // 16 + 3 * 64 * 32
    assert work_kimi.active_params(cb) == 2 * kda + 2 * mla + 3 * 64 * 96 + 3 * moe
    t3c = _config()["t3"]
    per_pos = 2 * work_kimi.active_params(cb) + 2 * 7 * 4 * 16 * 16
    att = lambda ctx: 2 * 2 * 4 * (16 + 8 + 16) * ctx
    head = 2 * 64 * t3c["speech_tokens_dict_size"]
    want = 2 * (2 * per_pos + att(1) + att(2) + head + per_pos + att(3) + head)
    assert work_kimi.t3_flops(t3c, context=2, tokens=1) == want


def test_weights_are_drawn_leaf_by_leaf_and_the_reference_gets_the_same_values():
    cfg = _config()
    served = model_kimi.make_t3(cfg, 7, "cpu")
    layer = model_kimi.reference_layer(cfg, 7, "cpu", 1)
    kp = served["llama"]["layers"][1]["kda"]
    assert torch.equal(kp["A_log"], layer["kda"]["A_log"])
    assert torch.equal(served["llama"]["layers"][1]["experts"]["down"]["w"],
                       layer["experts"]["down"]["w"])
    a = torch.exp(kp["A_log"])
    assert a.min() >= 0.99 and a.max() <= 16.1
    dt = torch.nn.functional.softplus(kp["dt_bias"])
    assert dt.min() >= 0.9e-4 and dt.max() <= 0.101
    bias = served["llama"]["layers"][1]["router"]["e_score_correction_bias"]
    assert bias.abs().max() <= 0.0501 and bias.std() > 0.01
    assert kp["conv"]["w"].abs().max() <= 0.501
    other = model_kimi.make_t3(cfg, 8, "cpu")
    assert not torch.equal(other["llama"]["layers"][1]["kda"]["q"]["w"], kp["q"]["w"])


def test_reference_agrees_with_the_port():
    out, lines = _run()
    assert out["correct"] is True, lines
    assert out["attempted"] > 0
    for k, v in out["checks"].items():
        assert v["value"] <= (0.05 if k == "hift_vs_bf16" else 1e-4), (k, v)


def test_control_is_not_correct():
    out, _ = _run(judge=lambda self, numbers_of: numbers_of("fp8"))
    assert out["correct"] is False


def _kda(monkeypatch, change):
    """K9 called on inputs that `change` edits: change(q, k, v, g, beta)."""
    from chatterbox_embed_tpu_torch.kernels import kda
    orig = kda.kda_recurrent

    def planted(q, k, v, g, beta, state, skip=None, read_state=True):
        q, k, v, g, beta = change(q.clone(), k.clone(), v.clone(), g.clone(), beta.clone())
        return orig(q, k, v, g, beta, state, skip, read_state)

    planted.launches = 0             # the kernel's wrapper counts on the name it is called by
    monkeypatch.setattr(kda, "kda_recurrent", planted)


def _bf16_state(monkeypatch):
    """The state rounded to bf16 after every token."""
    from chatterbox_embed_tpu_torch.kernels import kda
    orig = kda.kda_recurrent

    def rounded(q, k, v, g, beta, state, skip=None, read_state=True):
        outs = []
        for i in range(q.shape[1]):
            sl = slice(i, i + 1)
            live = None if skip is None else (skip > i).to(torch.int32)
            outs.append(orig(*(x[:, sl].contiguous() for x in (q, k, v, g, beta)), state, live,
                             read_state or i > 0))
            state.copy_(state.bfloat16().float())
        return torch.cat(outs, dim=1)

    rounded.launches = 0
    monkeypatch.setattr(kda, "kda_recurrent", rounded)


def _decay_channel_dropped(monkeypatch):
    """The first key channel of every head never decays."""
    def change(q, k, v, g, beta):
        g[..., 0] = 0.0
        return q, k, v, g, beta
    _kda(monkeypatch, change)


def _beta_one(monkeypatch):
    """The delta rule's step beta forced to 1."""
    def change(q, k, v, g, beta):
        return q, k, v, g, torch.ones_like(beta)
    _kda(monkeypatch, change)


def _stale_state(monkeypatch):
    """The slot insert leaves the slot's KDA states and windows as its last
    request left them."""
    from chatterbox_embed_tpu_torch.models import t3_engine
    orig = t3_engine.engine_insert

    def insert(state, sub, slot, draws, meta):
        rows = [slot, state.done.shape[0] + slot]
        kept = [(f[:, rows].clone(), f) for f in (state.cache.kda, state.cache.conv)]
        orig(state, sub, slot, draws, meta)
        for old, f in kept:
            f[:, rows] = old

    monkeypatch.setattr(t3_engine, "engine_insert", insert)


def _pad_in_state(monkeypatch):
    """The left pad's positions fed into the conv and the recurrence."""
    from chatterbox_embed_tpu_torch.models import kimi_linear
    orig = kimi_linear._seen

    def seen(attn_mask, cache_pos, t):
        valid, skip = orig(attn_mask, cache_pos, t)
        return torch.ones_like(valid), torch.zeros_like(skip)

    monkeypatch.setattr(kimi_linear, "_seen", seen)


def _dropped_expert(monkeypatch):
    """Each row's first chosen expert computed and routed, but its output
    left out of the sum (its weight zeroed)."""
    from chatterbox_embed_tpu_torch.models import deepseek_v2
    orig = deepseek_v2.route

    def dropped(lp, x, cfg):
        ids, w = orig(lp, x, cfg)
        return ids, torch.cat([torch.zeros_like(w[:, :1]), w[:, 1:]], dim=1)

    monkeypatch.setattr(deepseek_v2, "route", dropped)


@pytest.mark.parametrize("fault", [_decay_channel_dropped, _beta_one, _stale_state,
                                   _pad_in_state, _dropped_expert],
                         ids=lambda f: f.__name__.strip("_"))
def test_a_planted_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    out, lines = _run()
    assert out["correct"] is False, lines


def test_a_state_kept_in_bf16_moves_kda_state_rel(monkeypatch):
    """At this tiny size the program runs in fp32, so its states agree with
    the reference's to ~1e-6 and the cell's limits, set at its bf16 size, say
    nothing; the state rounded to bf16 after every token moves
    `kda_state_rel` a thousandfold, and at the cell's size it reads not
    correct (the card test below)."""
    sound, _ = _run()
    _bf16_state(monkeypatch)
    out, lines = _run()
    got, base = out["checks"]["kda_state_rel"]["value"], sound["checks"]["kda_state_rel"]["value"]
    assert got > 1000 * base and got > 1e-3, lines


def test_the_new_files_are_found_as_files():
    m = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    entry, e2e, layer = run.manifest_entries(m, CELL)
    assert entry["config"] == "chatterbox-t3-kimi-linear" and entry["chips"] == 1
    assert {x["name"] for x in e2e} == {"audio_s_per_s", "setup_s"}
    assert {x["name"] for x in layer} == {"mfu", "device_idle", "t3_step_ms.backlog",
                                          "vocode_share.backlog", "k3_roofline", "moe_roofline",
                                          "kda_roofline", "kda_share.kimi"}
    for x in layer:
        assert callable(run.metric_reader(x["name"]))
    cell = run.load_json(HERE / "workloads" / f"{CELL}.json")
    assert (HERE / "drivers" / f"{cell['driver']}.py").is_file()


def test_the_metrics_read_the_counters_and_the_trace():
    from types import SimpleNamespace
    cfg = json.loads((HERE / "configs" / "chatterbox-t3-kimi-linear.json").read_text())
    counters = {"profiled.kda.calls": 40, "profiled.kda.tokens": 40 * 32,
                "profiled.kda.states_read": 40 * 1024, "profiled.kda.states_written": 40 * 1024,
                "profiled.moe.calls": 26, "profiled.moe.assignments": 26 * 32,
                "profiled.moe.experts_touched": 26 * 20, "t_decode_s": 1.5, "steps": 100}
    trace = {"by_name": {"(anonymous namespace)::kda_kernel(...)": 0.004,
                         "void (anonymous namespace)::moe_kernel<true>(...)": 0.010,
                         "other": 0.1}, "busy_s": 0.5, "window_s": 1.0}
    r = SimpleNamespace(counters=counters, trace=trace, cfg=cfg, window_s=1.0)
    nbytes = 40 * 2048 * 128 * 128 * 4 + 40 * 32 * 32 * (5 * 128 + 1) * 4
    assert run.metric_reader("kda_roofline")(r) == pytest.approx(100 * nbytes / 3.35e12 / 0.004)
    assert run.metric_reader("kda_share.kimi")(r) == pytest.approx(100 * 0.004 / 0.5)
    bound = 26 * (20 * 3 * 2304 * 1024 * 2 + 32 * 2304 * 6) / 3.35e12
    assert run.metric_reader("moe_roofline")(r) == pytest.approx(100 * bound / 0.010)
    empty = SimpleNamespace(counters={}, trace={}, cfg=cfg, window_s=1.0)
    for name in ("kda_roofline", "kda_share.kimi"):
        assert run.metric_reader(name)(empty) is None


@pytest.mark.card
def test_control_at_the_cells_size_is_not_correct(card):
    """A window that completes requests (calibrate.py's 20 s), so that the
    check reads them."""
    out, lines = _run(seconds=20.0, judge=lambda self, numbers_of: numbers_of("fp8"),
                      device=card, small=False)
    print("\n".join(lines))
    assert out["attempted"] > 0, lines
    assert all(math.isfinite(v["value"]) for v in out["checks"].values()), lines
    assert out["correct"] is False, lines


@pytest.mark.card
@pytest.mark.parametrize("fault", [_bf16_state], ids=["bf16_state"])
def test_a_planted_fault_at_the_cells_size_is_not_correct(card, monkeypatch, fault):
    """The cell's own window, so that requests complete and the check reads
    them: the state kept in bf16 is caught by `kda_state_rel`, its worst
    head."""
    fault(monkeypatch)
    out, lines = _run(seconds=50.0, device=card, small=False)
    print("\n".join(lines))
    state = out["checks"]["kda_state_rel"]
    assert out["attempted"] > 0 and math.isfinite(state["value"]), lines
    assert out["correct"] is False and state["value"] > state["limit"], lines
