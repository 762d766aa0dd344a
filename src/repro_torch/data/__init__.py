"""data (port of repro.data)."""
