"""What a cell is built from: its configuration file, the weights, the
voices and the draw source, all made from the run's seed.

The weights are drawn on the device by one generator in one call (a flat
uniform buffer), then cut into the port's tree layout with a scale a leaf
and rounded to bfloat16. The values are the model: the program is handed
them in the type it serves them in, and the reference gets the same
values widened to fp32 (`make_weights(..., served=False)`), made again
from the seed.
"""
from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent.parent
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
EMBEDDINGS = ("text_emb", "speech_emb", "text_pos_emb", "speech_pos_emb", "input_embedding")


def load_config(name: str) -> dict:
    path = HERE / "configs" / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"no configuration file {path}")
    return json.loads(path.read_text())


def port_config(cfg: dict):
    """The port's ChatterboxConfig from a configuration dict."""
    from chatterbox_embed_tpu_torch import config as C

    def tup(v):
        return tuple(tup(x) for x in v) if isinstance(v, list) else v

    def make(cls, d, **sub):
        return cls(**{k: tup(v) for k, v in d.items() if k not in sub}, **sub)

    t3 = cfg["t3"]
    s3 = cfg["s3gen"]
    fl = s3["flow"]
    flow = make(C.FlowConfig, fl, encoder=make(C.ConformerConfig, fl["encoder"]),
                decoder=make(C.FlowDecoderConfig, fl["decoder"]), cfm=make(C.CFMConfig, fl["cfm"]))
    s3gen = make(C.S3GenConfig, s3, flow=flow, hift=make(C.HiFTConfig, s3["hift"]),
                 tokenizer=make(C.S3TokenizerConfig, s3["tokenizer"]))
    return C.ChatterboxConfig(t3=make(C.T3Config, t3, llama=make(C.LlamaConfig, t3["llama"])),
                              s3gen=s3gen)


def tree_layout(cfg: dict, parts) -> dict:
    """The port's parameter tree for `parts` ("t3", "flow", "hift",
    "tokenizer") as shape-only tensors."""
    from chatterbox_embed_tpu_torch.models import layers as L
    from chatterbox_embed_tpu_torch.models import s3gen as s3gen_mod
    from chatterbox_embed_tpu_torch.models import t3 as t3_mod
    pc = port_config(cfg)
    meta = L.Init(device="meta")
    out = {}
    if "t3" in parts:
        out["t3"] = t3_mod.init(meta, pc.t3)
    s3 = {k: v for k, v in s3gen_mod.init(meta, pc.s3gen).items() if k in parts}
    if s3:
        out["s3gen"] = s3
    return out


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


# HiFT's last convolution, drawn at a tenth of the spread with its bias
# shifted down (the configuration files' `assumed` say why)
QUIET = (("hift", "conv_post"), 0.1, -1.5)


def _rule(path, shape, siblings) -> tuple:
    """(kind, bound, shift): how a leaf is drawn. Norm scales, running
    variances and snake alphas are ones; norm biases and running means
    zeros; the rest uniform in [shift - bound, shift + bound] with the
    port's initialisers' spread (kaiming-uniform fan-in for weights,
    1/sqrt(fan-in) for biases, std 0.02 for embeddings), but for QUIET."""
    kind, bound = _spread(path, shape, siblings)
    (module, scale, shift) = QUIET
    if tuple(p for p in path[:-1] if isinstance(p, str))[-2:] == module:
        return kind, bound * scale, shift if path[-1] == "b" else 0.0
    return kind, bound, 0.0


def _spread(path, shape, siblings) -> tuple:
    name = path[-1] if isinstance(path[-1], str) else path[-2]
    parent = [p for p in path[:-1] if isinstance(p, str)]
    if name in ("scale", "var") or name in ("alpha1", "alpha2"):
        return "ones", 0.0
    if name in ("bias", "mean"):
        return "zeros", 0.0
    if any(p in EMBEDDINGS for p in parent):
        return "uniform", 0.02 * math.sqrt(3.0)
    if name == "query":
        return "uniform", math.sqrt(3.0) * math.sqrt(2.0 / (shape[1] + shape[1]))
    if name in ("pos_bias_u", "pos_bias_v"):
        return "uniform", math.sqrt(6.0 / (2 * shape[1]))
    if name == "w":
        if len(shape) == 2:
            fan = shape[0]
        elif "ups" in parent:
            fan = shape[1] * shape[2]
        else:
            fan = int(np.prod(shape[1:]))
        return "uniform", math.sqrt(3.0) / math.sqrt(fan)
    if name == "b":
        w = siblings.get("w")
        if w is None or "ups" in parent:
            return "zeros", 0.0
        fan = w.shape[0] if len(w.shape) == 2 else int(np.prod(w.shape[1:]))
        return "uniform", 1.0 / math.sqrt(fan)
    raise ValueError(f"no rule for the leaf {'.'.join(map(str, path))}")


def make_weights(cfg: dict, parts, seed: int, device, served: bool = True) -> dict:
    """The model's weights from `seed` on `device`. served: matmul and
    conv weights ("w", 2+ dims) in the configuration's dtype, the rest
    fp32 holding bfloat16 values (the port's `place` layout); otherwise
    every leaf fp32 (the reference's)."""
    layout = tree_layout(cfg, parts)
    leaves = list(_leaves(layout))
    total = sum(t.numel() for _, t in leaves)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    flat = torch.empty(total, device=device).uniform_(-1.0, 1.0, generator=gen)
    wdtype = DTYPES[cfg["dtype"]]
    off = 0
    out: dict = {}
    for path, t in leaves:
        parent = _get(layout, path[:-1])
        kind, bound, shift = _rule(path, tuple(t.shape), parent if isinstance(parent, dict) else {})
        n = t.numel()
        if kind == "ones":
            v = torch.ones(t.shape, device=device)
        elif kind == "zeros":
            v = torch.zeros(t.shape, device=device)
        else:
            v = flat[off:off + n].view(t.shape) * bound + shift
        off += n
        v = v.to(torch.bfloat16)
        is_w = path[-1] == "w" and len(t.shape) >= 2
        v = v.to(wdtype if (served and is_w) else torch.float32)
        _put(out, path, v)
    del flat
    return out


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _put(tree, path, value):
    for i, p in enumerate(path[:-1]):
        nxt = path[i + 1]
        if isinstance(tree, list):
            while len(tree) <= p:
                tree.append([] if isinstance(nxt, int) else {})
            tree = tree[p]
        else:
            tree = tree.setdefault(p, [] if isinstance(nxt, int) else {})
    last = path[-1]
    if isinstance(tree, list):
        while len(tree) <= last:
            tree.append(None)
        tree[last] = value
    else:
        tree[last] = value


def voices(cfg: dict, n: int, seed: int) -> list:
    """n voices shaped like a prepared 10 s prompt, from `seed`: T3's
    speaker embedding, prompt speech tokens and emotion; S3Gen's prompt
    tokens, prompt mel and x-vector. Plain numpy, handed to both sides."""
    rng = np.random.default_rng([int(seed), 7])
    v = cfg["voice"]
    out = []
    for _ in range(n):
        n_gen = v["s3gen_prompt_tokens"]
        out.append(dict(
            speaker_emb=rng.standard_normal(cfg["t3"]["speaker_embed_size"]).astype(np.float32),
            prompt_tokens=rng.integers(0, 6561, v["t3_prompt_tokens"]).astype(np.int64),
            emotion=float(v["emotion"]),
            gen=dict(prompt_token=rng.integers(0, 6561, (1, n_gen)).astype(np.int64),
                     prompt_token_len=np.array([n_gen], np.int64),
                     prompt_feat=rng.standard_normal((1, 2 * n_gen, 80)).astype(np.float32),
                     prompt_feat_len=None,
                     embedding=rng.standard_normal(
                         (1, cfg["s3gen"]["flow"]["spk_embed_dim"])).astype(np.float32))))
    return out


def port_conds(voice: dict, device):
    """A voice as the port's Conditionals."""
    from chatterbox_embed_tpu_torch.conditionals import Conditionals
    from chatterbox_embed_tpu_torch.models.t3 import T3Cond
    t3c = T3Cond(speaker_emb=torch.from_numpy(voice["speaker_emb"])[None],
                 cond_prompt_speech_tokens=torch.from_numpy(voice["prompt_tokens"])[None].int(),
                 emotion_adv=voice["emotion"])
    return Conditionals(t3c, voice["gen"]).to(device)


def source(cfg: dict, seed: int, device) -> "Source":
    """The run's vocoder draws, long enough for the widest dispatch."""
    return Source(seed, 2 * 1024 * 480, cfg["s3gen"]["hift"]["nb_harmonics"] + 1, device)


class Source:
    """The vocoder's source draws of a run: harmonic phases (1, 9, 1) and
    standard-normal noise (1, 9, n) made once from the seed. Every row of
    every dispatch takes their first samples, so a row's draws do not
    depend on the rows it was batched with, and the reference takes the
    same ones."""

    def __init__(self, seed: int, n_samples: int, n_harm: int, device):
        g = torch.Generator(device=device).manual_seed((int(seed) * 31 + 17) % (2 ** 63))
        self.phase = (torch.rand((1, n_harm, 1), generator=g, device=device) * 2 - 1) * math.pi
        self.noise = torch.randn((1, n_harm, n_samples), generator=g, device=device)


class Draws:
    """The draw source handed to the program for one request (T3's Gumbel
    noise, `gumbel`) or one vocoder dispatch (`Source`)."""

    def __init__(self, seed: int, source: Source, device):
        self.seed, self.source, self.device = int(seed), source, device
        self.gen = None

    def gumbel(self, step, shape):
        """The next step's noise: draws in call order from a generator
        seeded from the request's seed (`gumbel_steps` makes the same)."""
        if self.gen is None:
            self.gen = torch.Generator(device=self.device).manual_seed(self.seed)
        u = torch.rand(shape, generator=self.gen, device=self.device)
        return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))

    def phase(self, shape):
        return self.source.phase.expand(shape)

    def noise(self, shape):
        return self.source.noise[..., : shape[-1]].expand(shape)


def gumbel_steps(seed: int, n: int, vocab: int, device) -> torch.Tensor:
    """(n, vocab): the Gumbel noise of a request's first n decode steps, as
    its `Draws` hands them to the program one step at a time."""
    d = Draws(seed, None, device)
    return torch.stack([d.gumbel(i, (vocab,)) for i in range(n)])


class DrawFactory:
    """make_draws for the program: a request's or a dispatch's draws from
    its seed."""

    def __init__(self, source: Source, device):
        self.source, self.device = source, device

    def __call__(self, seed):
        return Draws(seed, self.source, self.device)


class MelKeeper:
    """Keeps the mel of every HiFT call on the served path (a patch of
    `hifigan.inference` in this process): device references until `take`,
    which the driver calls after the call that vocoded has handed its wavs
    to the host, so the copy waits for nothing."""

    def __init__(self):
        from chatterbox_embed_tpu_torch.models import hifigan
        self._mod, self._orig = hifigan, hifigan.inference
        self._kept = []

        def inference(params, mel, *args, **kwargs):
            self._kept.append(mel)
            return self._orig(params, mel, *args, **kwargs)

        hifigan.inference = inference

    def take(self) -> np.ndarray:
        """The rows of the mels kept since the last take, in call order,
        as one (rows, frames, 80) fp32 array."""
        rows = np.concatenate([m.float().cpu().numpy() for m in self._kept])
        self._kept.clear()
        return rows

    def remove(self):
        self._mod.inference = self._orig
