"""utils (port of repro.utils)."""
