"""The stacked client axis over ``torch.distributed`` ranks
(``sharding.ctx``), the port's counterpart of the JAX package's
``sharding`` package; the mesh itself is ``launch.mesh.engine_mesh``."""
