"""obs (port of repro.obs)."""
