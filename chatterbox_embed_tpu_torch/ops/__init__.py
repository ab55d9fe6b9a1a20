"""PyTorch ports of the JAX package's ops (sampling, STFT, mel, fbank,
resampling)."""
