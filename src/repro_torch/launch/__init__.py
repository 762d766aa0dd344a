"""launch (port of repro.launch)."""
