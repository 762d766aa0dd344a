"""configs (port of repro.configs)."""
