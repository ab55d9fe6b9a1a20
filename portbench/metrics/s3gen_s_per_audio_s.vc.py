"""Seconds inside `ChatterboxVC._tokens_to_wav` (wrapped; it ends in a
copy to the host) per second of audio it made in the window's unprofiled part."""


def read(run):
    s, audio = run.seconds.get("tokens_to_wav"), run.counters.get("audio_s")
    return None if not s or not audio else s / audio
