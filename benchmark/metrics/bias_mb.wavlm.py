"""``bias_mb.wavlm`` (MB/audio-s): the bytes of the position-bias tensors
the traced window's WavLM forwards wrote on the device (``wavlm.bias_bytes``,
counted by ``mmer_tpu_torch.models.wav2vec2``: the (H, T, T) table once a
forward, each layer's (B, H, T) gate, and any gated-bias tensor a route
materialises) over the seconds of audio embedded.  About 0.14 at 64 x 499
frames where the gated term is added into the scores in place, about 51
where each layer materialises it.  Source: the program's counters.  Layer:
model step.  Moves ``audio_s_per_s``."""

from benchmark import program
from benchmark.trace import Trace


def read(t: Trace):
    return program.per_unit(program.counters().get("wavlm.bias_bytes"), t.useful, 1e-6)
