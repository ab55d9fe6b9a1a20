"""PyTorch ports of the JAX package's models, module for module."""
