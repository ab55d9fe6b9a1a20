"""The comparison that decides `correct`, on the CPU at a tiny size: the
reference agrees with the port; the control (the reference in float8 in
the program's place) and faults planted in the timed path come out not
correct under the cells' own limits. On a card, the control at the cells'
own sizes."""
from __future__ import annotations

import pytest
import torch

import tiny
from portbench import run

SEED = 2 ** 31 + 12345
CELLS = ("tts-backlog", "vc-serial")


def _run(name, seconds=3.0, judge=None, device="cpu", small=True):
    cell = tiny.cell(name) if small else None
    cfg = tiny.config(cell["config"]) if small else None
    if judge is not None:
        orig = run.Ctx.judge
        run.Ctx.judge = judge
    try:
        return run.run_cell(name, SEED, seconds, False, device=device, cell=cell, cfg=cfg,
                            manifest=tiny.manifest())
    finally:
        if judge is not None:
            run.Ctx.judge = orig


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_the_port(name):
    out, lines = _run(name)
    assert out["correct"] is True, lines
    assert out["attempted"] > 0
    for k, v in out["checks"].items():
        # hift_vs_bf16 is in units of bf16 rounding, which an fp32 port stays far below
        assert v["value"] <= (0.05 if k == "hift_vs_bf16" else 1e-4), (k, v)


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    out, _ = _run(name, judge=lambda self, numbers_of: numbers_of("fp8"))
    assert out["correct"] is False


def _bad_token(monkeypatch):
    from chatterbox_embed_tpu_torch.ops import sampling
    orig = sampling.sample_token
    calls = [0]

    def altered(logits, gumbel):
        calls[0] += 1
        tok = orig(logits, gumbel)
        if calls[0] % 5:
            return tok
        worst = torch.where(torch.isfinite(logits), -logits, torch.full_like(logits, -1e30))
        return worst.argmax(-1)

    monkeypatch.setattr(sampling, "sample_token", altered)


def _bad_wav(monkeypatch):
    from chatterbox_embed_tpu_torch.models import hifigan
    orig = hifigan.inference
    monkeypatch.setattr(hifigan, "inference", lambda *a, **k: (lambda w, s: (-w, s))(*orig(*a, **k)))


def _stale_step(monkeypatch):
    """A decode step that returns its state unchanged: every third step
    hands back the tokens of the step before."""
    from chatterbox_embed_tpu_torch.ops import sampling
    orig = sampling.sample_token
    last = {}

    def stale(logits, gumbel):
        tok = orig(logits, gumbel)
        key = tuple(logits.shape)
        last["n"] = last.get("n", 0) + 1
        out = last[key] if key in last and last["n"] % 3 == 0 else tok
        last[key] = out
        return out

    monkeypatch.setattr(sampling, "sample_token", stale)


def _half_batch(monkeypatch):
    """Half of a vocode dispatch left out: the flow computes the first half
    of the rows and hands its mels to the rest."""
    from chatterbox_embed_tpu_torch.models import s3gen
    orig = s3gen.flow_to_mel

    def half(params, tokens, token_len, prompt_tokens, prompt_feat, embedding, *a, **k):
        b = tokens.shape[0]
        if b < 2:
            return orig(params, tokens, token_len, prompt_tokens, prompt_feat, embedding, *a, **k)
        h = (b + 1) // 2
        a = [x[:h] if torch.is_tensor(x) and x.dim() and x.shape[0] == b else x for x in a]
        mel = orig(params, tokens[:h], token_len[:h], prompt_tokens[:h], prompt_feat[:h],
                   embedding[:h], *a, **k)
        return torch.cat([mel, mel[: b - h]])

    monkeypatch.setattr(s3gen, "flow_to_mel", half)


def _bad_speech_token(monkeypatch):
    from chatterbox_embed_tpu_torch.models import s3tokenizer
    orig = s3tokenizer.fsq_quantize

    def altered(*a, **k):
        t = orig(*a, **k).clone()
        t[:, ::3] = (t[:, ::3] + 1) % 6561
        return t

    monkeypatch.setattr(s3tokenizer, "fsq_quantize", altered)


@pytest.mark.parametrize("name,fault,broken", [
    ("tts-backlog", _bad_token, "t3_gap"),
    ("tts-backlog", _bad_wav, "hift_vs_bf16"),
    ("tts-backlog", _stale_step, "t3_gap"),
    ("tts-backlog", _half_batch, "mel_rel"),
    ("vc-serial", _bad_speech_token, "token_mismatch"),
    ("vc-serial", _bad_wav, "hift_vs_bf16"),
])
def test_a_planted_fault_is_not_correct(monkeypatch, name, fault, broken):
    fault(monkeypatch)
    out, _ = _run(name)
    assert out["correct"] is False
    assert out["checks"][broken]["value"] > out["checks"][broken]["limit"]


@pytest.mark.card
@pytest.mark.parametrize("name", ("tts-backlog", "vc-serial"))
def test_control_at_the_cells_size_is_not_correct(card, name):
    out, _ = _run(name, seconds=10.0, judge=lambda self, numbers_of: numbers_of("fp8"),
                  device=card, small=False)
    assert out["correct"] is False
