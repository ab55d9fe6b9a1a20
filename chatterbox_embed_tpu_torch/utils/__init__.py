"""Host-side helpers of the port: audio I/O, checkpoint conversion and
safetensors checkpoints, watermarking, stage timers and profiler traces."""
