"""Host-side utilities (scene initialization)."""
