from .types import ContentType, ChunkInfo
from .smart_chunker import SmartChunker
from ..text.sanitizer import AdvancedTextSanitizer, STORY_BREAK_TOKEN
