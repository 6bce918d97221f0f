"""``audio_s_per_s`` (audio-s/s): the seconds of audio ``embed_batch``
returned embeddings for in the window over the whole window, padding not
counted."""

from benchmark.end_to_end import useful_rate as read  # noqa: F401
