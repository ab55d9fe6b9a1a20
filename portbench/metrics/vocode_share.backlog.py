"""The share of the window's unprofiled part spent inside the server's batched vocode
(`tts._vocode_batch`, wrapped; its wavs are host arrays, so the call has
synchronised), in %."""


def read(run):
    s = run.seconds.get("vocode")
    return None if not s else 100.0 * s / run.window_s
