"""Text helpers of the port."""
from .normalization import punc_norm  # noqa: F401
