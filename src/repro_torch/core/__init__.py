"""core (port of repro.core)."""
