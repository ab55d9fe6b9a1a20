from .analyzer import ChunkQualityAnalyzer, QualityScore
