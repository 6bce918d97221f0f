"""Host-side helpers shared by the port."""
