"""Host-side utilities (tracing, step timing)."""
