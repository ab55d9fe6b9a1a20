"""Host-side helpers of the port: audio I/O, checkpoint conversion,
watermarking (numpy only, apart from audio_io's resampling)."""
