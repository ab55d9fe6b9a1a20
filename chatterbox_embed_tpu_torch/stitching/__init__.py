from .stitcher import AdvancedStitcher
