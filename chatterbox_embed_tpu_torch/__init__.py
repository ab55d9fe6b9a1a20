"""chatterbox_embed_tpu_torch: the PyTorch / CUDA port of chatterbox_embed_tpu
for NVIDIA Hopper (H100), module for module beside the JAX package, which
stays the reference.

The port imports torch, numpy and the jax-free modules of the JAX package
(`chatterbox_embed_tpu.config`, `chatterbox_embed_tpu.utils.weights`), never
jax. Kernels that the JAX package writes in Pallas are written by hand for
sm_90a in `csrc/` and bound in `kernels/`.
"""

__version__ = "0.1.0"


def __getattr__(name):
    # lazy, like the JAX package: `import chatterbox_embed_tpu_torch` stays light
    if name == "ChatterboxTTS":
        from .tts import ChatterboxTTS
        return ChatterboxTTS
    raise AttributeError(name)
