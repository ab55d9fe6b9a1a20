"""Measurement entry points of the port's probe kernels: the counterparts of
the JAX package's `scripts/microbench_weight_stream.py` and
`scripts/microbench_decode_anatomy.py`. They run on a CUDA card only."""
