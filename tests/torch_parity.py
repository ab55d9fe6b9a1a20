"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py):
JAX's own random draws as a draw source for the port, and parameter-tree
conversion for single modules."""
import numpy as np
import torch
import jax
import jax.numpy as jnp

from chatterbox_embed_tpu_torch.models import layers as L
from chatterbox_embed_tpu_torch.weights import convert_tree


class JaxDraws:
    """The draws the JAX package makes from PRNGKey(seed), in the port's
    draw-source interface (chatterbox_embed_tpu_torch.ops.sampling.Draws):
    T3 step i samples with fold_in(key, i) (t3.py decode_block), the HiFT
    source splits the key in 3 for phase and noise (hifigan.sine_source)."""

    def __init__(self, seed: int = 0):
        self.key = jax.random.PRNGKey(seed)

    def gumbel(self, step, shape):
        k = jax.random.fold_in(self.key, step)
        return torch.from_numpy(np.array(jax.random.gumbel(k, shape, jnp.float32)))

    def phase(self, shape):
        k_phase = jax.random.split(self.key, 3)[0]
        return torch.from_numpy(np.array(
            jax.random.uniform(k_phase, shape, jnp.float32, -jnp.pi, jnp.pi)))

    def noise(self, shape):
        k_noise = jax.random.split(self.key, 3)[1]
        return torch.from_numpy(np.array(jax.random.normal(k_noise, shape, jnp.float32)))


def port_params(init_fn, cfg, jax_params, name="module"):
    """A JAX module's params converted into the port's tree for `init_fn`."""
    return convert_tree(init_fn(L.Init(device="meta"), cfg), jax_params, name)


def t(a, dtype=None):
    """numpy / jax array -> torch tensor."""
    x = torch.from_numpy(np.array(a))
    return x if dtype is None else x.to(dtype)
