"""models (port of repro.models)."""
