"""K8's wrapper (kernels/layer_norm.py) on the CPU, where it runs its plain
version, and S3Gen through it.

- The CPU path is `models/layers.py:layer_norm` bit for bit, computed in the
  wider of the input and output dtypes and cast once, over fp32 and bf16 in
  and out, widths 256, 512 and 1,024, eps 1e-5 and 1e-6, on a contiguous and
  a channel-first input; it counts no launch.
- The CFM estimator and token_to_wav (conformer, CFM, HiFT) at a tiny
  config give the bits that `layers.layer_norm` in each norm's place gives,
  the code before K8.
- The autograd Function's backward (the plain version's gradient,
  recomputed) equals autograd through the plain version.
- The layouts the kernel does not take are refused before any launch.

The kernel itself runs on the card (tests/test_torch_layer_norm_card.py).
"""
import numpy as np
import pytest
import torch

from chatterbox_embed_tpu_torch.config import (ConformerConfig, FlowDecoderConfig, HiFTConfig,
                                               S3GenConfig, S3TokenizerConfig, replace)
from chatterbox_embed_tpu_torch.kernels import layer_norm as K
from chatterbox_embed_tpu_torch.models import conformer, flow_decoder, s3gen
from chatterbox_embed_tpu_torch.models import layers as L
from chatterbox_embed_tpu_torch.ops.sampling import Draws

DTYPES = (torch.float32, torch.bfloat16)
DEC = FlowDecoderConfig(in_channels=32, out_channels=8, channels=16, attention_head_dim=8,
                        num_heads=2, n_blocks=1, num_mid_blocks=2, time_embed_dim=64)
S3 = S3GenConfig(flow=replace(S3GenConfig().flow, decoder=DEC, input_size=32, output_size=8,
                              encoder=ConformerConfig(input_size=32, output_size=32,
                                                      attention_heads=4, linear_units=64,
                                                      num_blocks=2, num_up_blocks=1)),
                 hift=HiFTConfig(in_channels=8, base_channels=32, f0_cond_channels=16),
                 tokenizer=S3TokenizerConfig(n_state=64, n_heads=4, n_layers=1), mel_num=8)


def _norm(width, seed):
    g = torch.Generator().manual_seed(seed)
    return {"scale": 1 + 0.3 * torch.randn(width, generator=g),
            "bias": 0.2 * torch.randn(width, generator=g)}


def _old_norm(p, x, eps=1e-5, out_dtype=None):
    """What each of S3Gen's norms computed before K8."""
    return L.layer_norm(p, x, eps)


@pytest.fixture
def no_launches():
    K.layer_norm.launches = 0
    yield
    assert K.layer_norm.launches == 0, "the CPU path counted a launch"


@pytest.mark.parametrize("layout", ("contiguous", "channel_first"))
@pytest.mark.parametrize("eps", (1e-5, 1e-6))
@pytest.mark.parametrize("width", (256, 512, 1024))
@pytest.mark.parametrize("out_dtype", DTYPES)
@pytest.mark.parametrize("in_dtype", DTYPES)
def test_the_cpu_path_is_layers_layer_norm_cast_once(in_dtype, out_dtype, width, eps, layout,
                                                     no_launches):
    g = torch.Generator().manual_seed(width)
    x = (3 * torch.randn((2, 7, width), generator=g) + 0.5).to(in_dtype)
    if layout == "channel_first":
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
        assert not x.is_contiguous()
    p = _norm(width, 1)
    got = K.layer_norm(p, x, eps, out_dtype)
    # the norm in the wider dtype, then one rounding
    wide = x if in_dtype == torch.float32 or out_dtype == torch.bfloat16 else x.float()
    want = L.layer_norm(p, wide, eps).to(out_dtype)
    assert got.dtype == out_dtype and got.shape == x.shape
    assert torch.equal(got, want)
    assert torch.equal(K.layer_norm(p, x, eps), L.layer_norm(p, x, eps))


def _flow_inputs(b, tlen, seed):
    rng = np.random.default_rng(seed)
    x, mu, cond = (torch.as_tensor(rng.standard_normal((b, tlen, 8)), dtype=torch.float32)
                   for _ in range(3))
    spks = torch.as_tensor(rng.standard_normal((b, 8)), dtype=torch.float32)
    lens = torch.as_tensor(rng.integers(tlen // 2, tlen + 1, b))
    mask = (torch.arange(tlen)[None, :, None] < lens[:, None, None]).float()
    t = torch.as_tensor(rng.uniform(0, 1, b), dtype=torch.float32)
    return x, mu, t, spks, cond, mask


@pytest.mark.parametrize("rows", (2, 4))
@pytest.mark.parametrize("dtype", DTYPES)
def test_the_estimator_gives_the_bits_of_the_plain_norms(dtype, rows, monkeypatch, no_launches):
    """forward_mid_cached, fresh and with its mid stack reused (DeepCache),
    below and at K3's 4-row gate."""
    params = flow_decoder.init(L.Init(2, "cpu"), DEC)
    args = _flow_inputs(rows, 20, rows)
    with torch.no_grad():
        got, mid = flow_decoder.forward_mid_cached(params, *args, cfg=DEC, dtype=dtype)
        got_reused, _ = flow_decoder.forward_mid_cached(params, *args, cfg=DEC, dtype=dtype,
                                                        mid_feats=mid, reuse_mid=True)
        monkeypatch.setattr(flow_decoder, "layer_norm", _old_norm)
        want, want_mid = flow_decoder.forward_mid_cached(params, *args, cfg=DEC, dtype=dtype)
        want_reused, _ = flow_decoder.forward_mid_cached(params, *args, cfg=DEC, dtype=dtype,
                                                         mid_feats=want_mid, reuse_mid=True)
    assert torch.equal(got, want) and torch.equal(mid, want_mid)
    assert torch.equal(got_reused, want_reused)


@pytest.mark.parametrize("dtype", DTYPES)
def test_token_to_wav_gives_the_bits_of_the_plain_norms(dtype, monkeypatch, no_launches):
    params = s3gen.init(L.Init(5, "cpu"), S3)
    rng = np.random.default_rng(5)
    toks = torch.zeros((1, 16), dtype=torch.int64)
    toks[0, :11] = torch.as_tensor(rng.integers(0, 6561, 11))
    args = (toks, torch.tensor([17]), torch.as_tensor(rng.integers(0, 6561, (1, 6))),
            torch.as_tensor(rng.standard_normal((1, 12, 8)), dtype=torch.float32),
            torch.as_tensor(rng.standard_normal((1, 192)), dtype=torch.float32))
    with torch.no_grad():
        got = s3gen.token_to_wav(params, *args, Draws(3, "cpu"), S3, dtype)
        monkeypatch.setattr(flow_decoder, "layer_norm", _old_norm)
        monkeypatch.setattr(conformer, "layer_norm", _old_norm)
        want = s3gen.token_to_wav(params, *args, Draws(3, "cpu"), S3, dtype)
    assert got.shape == (1, 32 * 480)
    assert torch.equal(got, want)


@pytest.mark.parametrize("out_dtype", DTYPES)
@pytest.mark.parametrize("in_dtype", DTYPES)
def test_the_functions_backward_is_the_plain_gradient(in_dtype, out_dtype, monkeypatch):
    """_LayerNorm (the card's autograd route) with its launch replaced by the
    plain version: its gradients equal autograd through the plain version."""
    monkeypatch.setattr(K, "_launch", lambda x, s, b, eps, od: K.layer_norm_reference(
        {"scale": s, "bias": b}, x, eps, od))
    g = torch.Generator().manual_seed(7)
    x0 = torch.randn((3, 5, 256), generator=g).to(in_dtype)
    p0 = _norm(256, 2)
    dy = torch.randn((3, 5, 256), generator=g).to(out_dtype)
    grads = []
    for route in ("function", "plain"):
        x = x0.clone().requires_grad_(True)
        p = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
        if route == "function":
            y = K._LayerNorm.apply(x, p["scale"], p["bias"], 1e-5, out_dtype)
        else:
            y = K.layer_norm_reference(p, x, 1e-5, out_dtype)
        y.backward(dy)
        grads.append((x.grad, p["scale"].grad, p["bias"].grad))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_only_the_input_that_needs_a_gradient_gets_one(monkeypatch):
    monkeypatch.setattr(K, "_launch", lambda x, s, b, eps, od: K.layer_norm_reference(
        {"scale": s, "bias": b}, x, eps, od))
    x = torch.randn((4, 256), requires_grad=True)
    p = _norm(256, 3)
    K._LayerNorm.apply(x, p["scale"], p["bias"], 1e-5, torch.float32).sum().backward()
    assert x.grad is not None and p["scale"].grad is None and p["bias"].grad is None


@pytest.mark.parametrize("case, why", (("strided_last_axis", "neither"), ("permuted", "neither"),
                                       ("width", "width"), ("dtype", "dtypes"),
                                       ("scale_dtype", "scale"), ("device", "device")))
def test_what_the_kernel_does_not_take_is_refused(case, why):
    """The CUDA route's checks, run here on tensors that never reach a card."""
    x = torch.randn((2, 6, 512))
    p = _norm(512, 4)
    out = torch.float32
    if case == "strided_last_axis":
        x = x[..., ::2]
        p = _norm(256, 4)
    elif case == "permuted":
        x = torch.randn((6, 256, 2)).permute(2, 0, 1)
        p = _norm(256, 4)
    elif case == "width":
        x = torch.randn((2, 6, 384))
        p = _norm(384, 4)
    elif case == "dtype":
        out = torch.float16
    elif case == "scale_dtype":
        p = {k: v.bfloat16() for k, v in p.items()}
    with pytest.raises(ValueError, match=why):
        if case == "device":
            K.layer_norm({k: v.to("meta") for k, v in p.items()}, x.to("meta"), 1e-5, out)
        elif case in ("strided_last_axis", "permuted"):
            K._layout(x)
        else:
            K._check(x, p["scale"], p["bias"], out)


def test_the_layouts_the_kernel_takes():
    x = torch.randn((2, 6, 256))
    assert K._layout(x) == 0
    assert K._layout(x.transpose(1, 2).contiguous().transpose(1, 2)) == 1
    assert K._layout(torch.randn((1, 1, 256))) == 0
