"""PyTorch/CUDA port of the federated-learning system in ``repro``.

A second package beside the JAX one, with the same module paths and
names. It imports torch and numpy, never jax and nothing of ``repro``:
the host-plane modules it needs (configs, env, data) are its own copies.
Entry points run on ``cuda`` unless the caller asks for the CPU
(``utils.device.resolve_device``); the server-plane kernels are
hand-written CUDA C++ for ``sm_90a`` (``kernels/csrc``).
"""
