"""K8 (kernels/layer_norm.py) on the card, against its plain version.

- The served shapes: the CFM estimator's 12,288 and 20,480 rows x 256
  (a 4-request vocode flush, 8 estimator rows with CFG, at 1,536 and
  2,560 frames), fp32 -> bf16 and bf16 -> bf16, in the
  channel-first layout the estimator hands it and contiguous; the
  conformer's rows x 512, bf16, contiguous; fp32 -> fp32 at every width.
  An fp32 output is held within 1e-5 of max(|ref|, rms(ref)) of the plain
  version's, a bf16 one within one bf16 step of max(|out|, |ref|, rms(ref))
  (the two round the same fp32 norm, whose last bits differ by the order
  of the row sums; near zero, where y * scale + bias cancels, those bits
  are many of a small value's steps).
- Row counts that are no multiple of a block: a ragged last block in both
  layouts, and a single row.
- A last axis that is not contiguous is refused.
- Through autograd the Function's gradients equal the plain version's.
- K8 captured in a CUDA graph (utils/graphs.py) and replayed on new values
  gives the eager launch's bits, one launch counted a replay.
- The estimator and the conformer at their served widths launch K8 on every
  norm (141 a fresh estimator call, 21 a reused one, 23 a conformer call)
  and stay near the plain norms' output.

The tests need a CUDA card and skip without one. This file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -s tests/test_torch_layer_norm_card.py
"""
import pytest
import torch

from chatterbox_embed_tpu_torch.config import ConformerConfig, FlowDecoderConfig
from chatterbox_embed_tpu_torch.kernels import layer_norm as K
from chatterbox_embed_tpu_torch.models import conformer, flow_decoder
from chatterbox_embed_tpu_torch.models import layers as L
from chatterbox_embed_tpu_torch.utils import graphs

F32, BF16 = torch.float32, torch.bfloat16
FP32_TOL = 1e-5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the chip")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _input(shape, dtype, layout, dev, seed):
    """x (..., T, W) drawn with a per-row offset and spread, contiguous or
    channel-first (stored (..., W, T))."""
    g = torch.Generator(device=dev).manual_seed(seed)
    *lead, t, w = shape
    if layout == "channel_first":
        x = torch.randn((*lead, w, t), generator=g, device=dev)
        x = (x * (1 + 2 * torch.rand((*lead, 1, t), generator=g, device=dev))
             + torch.randn((*lead, 1, t), generator=g, device=dev))
        return x.to(dtype).transpose(-1, -2)
    x = torch.randn(shape, generator=g, device=dev)
    x = (x * (1 + 2 * torch.rand((*lead, t, 1), generator=g, device=dev))
         + torch.randn((*lead, t, 1), generator=g, device=dev))
    return x.to(dtype)


def _params(w, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return {"scale": 1 + 0.3 * torch.randn(w, generator=g, device=dev),
            "bias": 0.2 * torch.randn(w, generator=g, device=dev)}


def _assert_close(out, ref, what):
    """fp32: within FP32_TOL of max(|ref|, rms(ref)); bf16: within one bf16
    step of max(|out|, |ref|, rms(ref))."""
    torch.cuda.synchronize()
    assert out.dtype == ref.dtype and out.shape == ref.shape, what
    o, r = out.float(), ref.float()
    diff = (o - r).abs()
    floor = r.pow(2).mean().sqrt()
    if out.dtype == F32:
        worst = (diff / r.abs().clamp_min(floor)).max().item()
        assert worst <= FP32_TOL, f"{what}: {worst:.3e} of max(|ref|, rms)"
    else:
        big = torch.maximum(o.abs(), r.abs()).clamp_min(floor)
        step = torch.exp2(torch.floor(torch.log2(big)) - 7)
        worst = (diff / step).max().item()
        assert worst <= 1.0, f"{what}: {worst:.2f} bf16 steps"


@pytest.mark.card
@pytest.mark.parametrize("layout", ("channel_first", "contiguous"))
@pytest.mark.parametrize("in_dtype", (F32, BF16))
@pytest.mark.parametrize("shape", ((8, 1536, 256), (8, 2560, 256)))
def test_k8_equals_its_plain_version_at_the_estimators_shapes(card, shape, in_dtype, layout):
    x = _input(shape, in_dtype, layout, card, 1)
    p = _params(shape[-1], card, 2)
    K.layer_norm.launches = 0
    out = K.layer_norm(p, x, 1e-5, BF16)
    assert K.layer_norm.launches == 1
    assert out.stride() == x.stride(), "the output keeps the input's layout"
    _assert_close(out, K.layer_norm_reference(p, x, 1e-5, BF16), f"{shape} {in_dtype} {layout}")


@pytest.mark.card
@pytest.mark.parametrize("eps", (1e-5, 1e-12))
@pytest.mark.parametrize("shape", ((4, 768, 512), (4, 1536, 512)))
def test_k8_equals_its_plain_version_at_the_conformers_shapes(card, shape, eps):
    x = _input(shape, BF16, "contiguous", card, 3)
    p = _params(512, card, 4)
    _assert_close(K.layer_norm(p, x, eps), K.layer_norm_reference(p, x, eps), f"{shape} {eps}")


@pytest.mark.card
@pytest.mark.parametrize("layout", ("channel_first", "contiguous"))
@pytest.mark.parametrize("width", (256, 512, 1024))
def test_k8_in_fp32_at_every_width(card, width, layout):
    x = _input((3, 700, width), F32, layout, card, width)
    p = _params(width, card, 5)
    for out_dtype in (F32, BF16):
        _assert_close(K.layer_norm(p, x, 1e-6, out_dtype),
                      K.layer_norm_reference(p, x, 1e-6, out_dtype), f"{width} {out_dtype}")


@pytest.mark.card
@pytest.mark.parametrize("layout", ("channel_first", "contiguous"))
@pytest.mark.parametrize("t_len", (1, 17, 1537))
def test_a_ragged_last_block(card, t_len, layout):
    """Row blocks of 16 rows (width 256) and column tiles of 32 frames: the
    rows past the end are neither read nor written."""
    x = _input((3, t_len, 256), BF16, layout, card, t_len)
    p = _params(256, card, 6)
    _assert_close(K.layer_norm(p, x), K.layer_norm_reference(p, x), f"T {t_len} {layout}")


@pytest.mark.card
def test_a_last_axis_that_is_not_contiguous_is_refused(card):
    x = _input((2, 64, 512), BF16, "contiguous", card, 7)[..., ::2]
    K.layer_norm.launches = 0
    with pytest.raises(ValueError, match="neither contiguous nor channel-first"):
        K.layer_norm(_params(256, card, 8), x)
    with pytest.raises(ValueError, match="width"):
        K.layer_norm(_params(384, card, 8), _input((2, 64, 384), BF16, "contiguous", card, 7))
    assert K.layer_norm.launches == 0


@pytest.mark.card
@pytest.mark.parametrize("layout", ("channel_first", "contiguous"))
@pytest.mark.parametrize("out_dtype", (F32, BF16))
def test_gradients_through_the_function_equal_the_plain_versions(card, out_dtype, layout):
    x0 = _input((4, 300, 256), F32, layout, card, 9)
    p0 = _params(256, card, 10)
    dy = torch.randn((4, 300, 256), device=card).to(out_dtype)
    grads, outs = [], []
    for route in ("kernel", "plain"):
        x = x0.detach().clone().requires_grad_(True)
        p = {k: v.detach().clone().requires_grad_(True) for k, v in p0.items()}
        fn = K.layer_norm if route == "kernel" else K.layer_norm_reference
        y = fn(p, x, 1e-5, out_dtype)
        y.backward(dy)
        outs.append(y.detach())
        grads.append((x.grad, p["scale"].grad, p["bias"].grad))
    _assert_close(outs[0], outs[1], "forward under autograd")
    for name, a, b in zip(("x", "scale", "bias"), *grads):
        assert torch.equal(a, b), f"d{name}"


@pytest.mark.card
@pytest.mark.parametrize("layout", ("channel_first", "contiguous"))
def test_k8_captured_in_a_graph_replays_the_eager_bits(card, layout):
    x = _input((8, 1536, 256), F32, layout, card, 11)
    p = _params(256, card, 12)
    # the warm-up builds and loads the kernel before the capture
    graph = graphs.Graphed([lambda: K.layer_norm(p, x, 1e-5, BF16)], card)
    graph.step()
    assert graph.launches == [{"layer_norm": 1}]
    for seed in (13, 14):
        x.copy_(_input((8, 1536, 256), F32, layout, card, seed))
        out = graph.step()
        torch.cuda.synchronize()
        assert torch.equal(out, K.layer_norm(p, x, 1e-5, BF16)), f"seed {seed}"


@pytest.mark.card
@pytest.mark.parametrize("dtype", (F32, BF16))
def test_the_estimator_and_the_conformer_launch_k8_on_every_norm(card, dtype):
    """At the served widths (FlowDecoderConfig(), ConformerConfig()) on 4
    rows: launches per call, and the output near the plain norms'."""
    dec, conf = FlowDecoderConfig(), ConformerConfig()
    fp = flow_decoder.init(L.Init(1, card), dec)
    cp = conformer.init(L.Init(2, card), conf)
    g = torch.Generator(device=card).manual_seed(3)
    b, t = 4, 96
    x, mu, cond = (torch.randn((b, t, 80), generator=g, device=card) for _ in range(3))
    spks = torch.randn((b, 80), generator=g, device=card)
    tt = torch.rand((b,), generator=g, device=card)
    mask = (torch.arange(t, device=card)[None, :, None]
            < torch.tensor([96, 80, 96, 50], device=card)[:, None, None]).float()
    tok = torch.randn((b, t // 2, 512), generator=g, device=card)
    lens = torch.tensor([48, 40, 48, 25], device=card)

    def run():
        with torch.no_grad():
            v, mid = flow_decoder.forward_mid_cached(fp, x, mu, tt, spks, cond, mask, dec, dtype)
            fresh = K.layer_norm.launches
            v2, _ = flow_decoder.forward_mid_cached(fp, x, mu, tt, spks, cond, mask, dec, dtype,
                                                    mid_feats=mid, reuse_mid=True)
            reused = K.layer_norm.launches - fresh
            h = conformer.forward(cp, tok, lens, conf, dtype)
        return (v, v2, h), (fresh, reused, K.layer_norm.launches - fresh - reused)

    K.layer_norm.launches = 0
    got, counts = run()
    assert counts == (141, 21, 23)
    plain = lambda p, x, eps=1e-5, out_dtype=None: K.layer_norm_reference(p, x, eps, out_dtype)
    mp = pytest.MonkeyPatch()
    mp.setattr(flow_decoder, "layer_norm", plain)
    mp.setattr(conformer, "layer_norm", plain)
    try:
        want, _ = run()
    finally:
        mp.undo()
    for name, a, w in zip(("fresh", "reused", "conformer"), got, want):
        rel = ((a.float() - w.float()).norm() / w.float().norm()).item()
        print(f"{name} {dtype}: relative distance from the plain norms {rel:.3e}")
        assert torch.isfinite(a).all() and rel <= (1e-4 if dtype == F32 else 3e-2), name
