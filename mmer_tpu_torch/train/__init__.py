"""Training of the fusion classifier (the port of ``mmer_tpu/train``)."""
