"""Host data pipeline (the port of ``mmer_tpu/data``; numpy only)."""
