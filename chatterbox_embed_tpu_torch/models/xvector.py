"""CAMPPlus x-vector speaker encoder producing the 192-d voice-clone
embedding, the PyTorch counterpart of `chatterbox_embed_tpu/models/
xvector.py` (this embedding is the `.npy` voice-clone payload).

Public layouts stay channel-last, as in the JAX package: (B, T, C) for the
1-D stack and (B, F, T, C) for the 2-D front end; the convolutions permute
to torch's layout inside `layers.conv1d` / `layers.conv2d`. Batch norms are
in eval form. Runs in fp32 (the JAX package passes no compute dtype here).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..config import CAMPPlusConfig
from ..device import full_fp32
from ..ops import fbank as fbank_ops
from . import layers as L


def init(init: L.Init, cfg: CAMPPlusConfig = CAMPPlusConfig()):
    m = cfg.m_channels

    def res_block(c_in, c_out, stride):
        p = {
            "conv1": L.conv2d_init(init, 3, 3, c_in, c_out, bias=False),
            "bn1": L.batch_norm_init(init, c_out),
            "conv2": L.conv2d_init(init, 3, 3, c_out, c_out, bias=False),
            "bn2": L.batch_norm_init(init, c_out),
        }
        if stride != 1 or c_in != c_out:
            p["sc_conv"] = L.conv2d_init(init, 1, 1, c_in, c_out, bias=False)
            p["sc_bn"] = L.batch_norm_init(init, c_out)
        return p

    fcm = {
        "conv1": L.conv2d_init(init, 3, 3, 1, m, bias=False),
        "bn1": L.batch_norm_init(init, m),
        "layer1": [res_block(m, m, 2), res_block(m, m, 1)],
        "layer2": [res_block(m, m, 2), res_block(m, m, 1)],
        "conv2": L.conv2d_init(init, 3, 3, m, m, bias=False),
        "bn2": L.batch_norm_init(init, m),
    }

    channels = m * (cfg.feat_dim // 8)      # 32 * 10 = 320
    tdnn = {"conv": L.conv1d_init(init, 5, channels, cfg.init_channels, bias=False),
            "bn": L.batch_norm_init(init, cfg.init_channels)}
    channels = cfg.init_channels

    blocks = []
    transits = []
    bn_ch = cfg.bn_size * cfg.growth_rate
    for num_layers, ksz, _dil in zip(cfg.block_layers, cfg.block_kernels, cfg.block_dilations):
        layers = []
        for i in range(num_layers):
            c_in = channels + i * cfg.growth_rate
            layers.append({
                "bn1": L.batch_norm_init(init, c_in),
                "linear1": L.conv1d_init(init, 1, c_in, bn_ch, bias=False),
                "bn2": L.batch_norm_init(init, bn_ch),
                "cam_local": L.conv1d_init(init, ksz, bn_ch, cfg.growth_rate, bias=False),
                "cam_l1": L.conv1d_init(init, 1, bn_ch, bn_ch // 2),
                "cam_l2": L.conv1d_init(init, 1, bn_ch // 2, cfg.growth_rate),
            })
        blocks.append({"layers": layers})
        channels += num_layers * cfg.growth_rate
        transits.append({"bn": L.batch_norm_init(init, channels),
                         "conv": L.conv1d_init(init, 1, channels, channels // 2, bias=False)})
        channels //= 2

    head = {
        "out_bn": L.batch_norm_init(init, channels),
        "dense_conv": L.conv1d_init(init, 1, channels * 2, cfg.embedding_size, bias=False),
        "dense_bn": L.batch_norm_init(init, cfg.embedding_size),
    }
    return {"fcm": fcm, "tdnn": tdnn, "blocks": blocks, "transits": transits, "head": head}


def _res_block(p, x, stride):
    y = torch.relu(L.batch_norm(p["bn1"], L.conv2d(p["conv1"], x, stride=(stride, 1), padding=1)))
    y = L.batch_norm(p["bn2"], L.conv2d(p["conv2"], y, stride=(1, 1), padding=1))
    if "sc_conv" in p:
        sc = L.batch_norm(p["sc_bn"], L.conv2d(p["sc_conv"], x, stride=(stride, 1), padding=0))
    else:
        sc = x
    return torch.relu(y + sc)


def _fcm(p, feats):
    """feats (B, T, F=80) -> (B, T, 320)."""
    x = feats.transpose(1, 2)[..., None]             # (B, F, T, 1), H = freq
    x = torch.relu(L.batch_norm(p["bn1"], L.conv2d(p["conv1"], x, padding=1)))
    for i, blk in enumerate(p["layer1"]):
        x = _res_block(blk, x, 2 if i == 0 else 1)
    for i, blk in enumerate(p["layer2"]):
        x = _res_block(blk, x, 2 if i == 0 else 1)
    x = torch.relu(L.batch_norm(p["bn2"], L.conv2d(p["conv2"], x, stride=(2, 1), padding=1)))
    b, f, t, c = x.shape                             # f = 10
    # the reference reshapes (B, C, F, T) -> (B, C*F, T); match that interleaving
    return x.permute(0, 2, 3, 1).reshape(b, t, c * f)


def _seg_pool_avg(x, seg_len=100):
    """Ceil-mode segment average expanded back to T: the last segment is
    averaged over its own (shorter) length."""
    b, t, c = x.shape
    n_seg = -(-t // seg_len)
    xp = F.pad(x, (0, 0, 0, n_seg * seg_len - t))
    sums = xp.reshape(b, n_seg, seg_len, c).sum(dim=2)
    counts = np.minimum(seg_len, t - np.arange(n_seg) * seg_len).astype(np.float32)
    seg = sums / torch.from_numpy(counts).to(x.device)[None, :, None]
    return seg.repeat_interleave(seg_len, dim=1)[:, :t]


def _cam_layer(p, x, ksz, dilation):
    y = L.conv1d(p["cam_local"], x, padding=(ksz - 1) // 2 * dilation, dilation=dilation)
    context = x.mean(dim=1, keepdim=True) + _seg_pool_avg(x)
    m = torch.sigmoid(L.conv1d(p["cam_l2"], torch.relu(L.conv1d(p["cam_l1"], context))))
    return y * m


def _dense_layer(p, x, ksz, dilation):
    y = L.conv1d(p["linear1"], torch.relu(L.batch_norm(p["bn1"], x)))
    return _cam_layer(p, torch.relu(L.batch_norm(p["bn2"], y)), ksz, dilation)


@torch.no_grad()
def forward(params, feats: torch.Tensor, cfg: CAMPPlusConfig = CAMPPlusConfig()):
    """feats: (B, T, 80) mean-normalised kaldi fbank -> (B, 192) embedding."""
    with full_fp32():
        x = _fcm(params["fcm"], feats.float())
        x = torch.relu(L.batch_norm(params["tdnn"]["bn"],
                                    L.conv1d(params["tdnn"]["conv"], x, stride=2, padding=2)))
        for bi, (block, transit) in enumerate(zip(params["blocks"], params["transits"])):
            ksz, dil = cfg.block_kernels[bi], cfg.block_dilations[bi]
            for layer in block["layers"]:
                x = torch.cat([x, _dense_layer(layer, x, ksz, dil)], dim=-1)
            x = L.conv1d(transit["conv"], torch.relu(L.batch_norm(transit["bn"], x)))
        x = torch.relu(L.batch_norm(params["head"]["out_bn"], x))
        # stats pooling: mean + unbiased std over time
        mean = x.mean(dim=1)
        var = (x - mean[:, None, :]).square().sum(dim=1) / max(x.shape[1] - 1, 1)
        stats = torch.cat([mean, torch.sqrt(var + 1e-10)], dim=-1)[:, None, :]
        emb = L.conv1d(params["head"]["dense_conv"], stats)
        emb = L.batch_norm(params["head"]["dense_bn"], emb)
        return emb[:, 0, :]


@torch.no_grad()
def inference(params, wav_16k: torch.Tensor, cfg: CAMPPlusConfig = CAMPPlusConfig()):
    """wav_16k: (B, T) -> (B, 192), with the kaldi-fbank + mean-normalising
    front end."""
    feats = fbank_ops.kaldi_fbank(wav_16k)            # (B, F, 80)
    feats = feats - feats.mean(dim=1, keepdim=True)
    return forward(params, feats, cfg)
