"""`audio_s_per_s`: seconds of audio of every request finished in the
window over the window (host clock, from the first send to the last
completion)."""

from harness import readers


def read(run):
    return readers.audio_s_per_s(run)
