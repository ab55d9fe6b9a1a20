"""chatterbox_embed_tpu_torch: the PyTorch / CUDA port of chatterbox_embed_tpu
for NVIDIA Hopper (H100), module for module beside the JAX package, which
stays the reference.

The port imports torch, numpy and scipy, never jax and nothing of the JAX
package: what it needs from a jax-free module there (`config.py`,
`utils/weights.py`, the wav reader, the watermarker, the text normaliser) it
keeps as its own copy. Its entry points run on the CUDA card unless the
caller asks for another device (`device="cpu"`, as the tests do). Kernels
that the JAX package writes in Pallas are written by hand for sm_90a in
`csrc/` and bound in `kernels/`.
"""

__version__ = "0.1.0"


def __getattr__(name):
    # lazy, like the JAX package: `import chatterbox_embed_tpu_torch` stays light
    if name == "ChatterboxTTS":
        from .tts import ChatterboxTTS
        return ChatterboxTTS
    if name == "ChatterboxVC":
        from .vc import ChatterboxVC
        return ChatterboxVC
    raise AttributeError(name)
