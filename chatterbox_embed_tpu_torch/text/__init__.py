"""Text helpers of the port."""
from .normalization import punc_norm  # noqa: F401
from .sanitizer import STORY_BREAK_TOKEN, AdvancedTextSanitizer  # noqa: F401
