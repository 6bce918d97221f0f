"""``chunks_per_s`` (chunks/s): the chunks ``embed_chunks`` returned in the
window over the whole window, padding rows not counted."""

from benchmark.end_to_end import useful_rate as read  # noqa: F401
