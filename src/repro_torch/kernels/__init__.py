"""kernels (port of repro.kernels)."""
