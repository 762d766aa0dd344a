"""Round-state checkpoints (``io``), interchangeable with the JAX package's."""
