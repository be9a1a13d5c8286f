"""``audio_rate``: seconds of 24 kHz PCM that reached the clients inside
the window, over the window's seconds. A streamed block counts when it
arrives, a one-shot request's audio when it resolves."""

from pbench import derive


def read(run):
    return derive.audio_seconds_in_window(run) / run.seconds
