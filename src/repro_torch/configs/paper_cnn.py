"""The paper's own evaluation model: 2 conv (5x5) + 3 FC, 10 classes.

Used for the paper-faithful AMA-FES experiments (Fig. 2 / Fig. 3 scale:
K=50 clients, m=10/round, MNIST/FMNIST-shaped 28x28x1 inputs).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paper-cnn",
    family="cnn",
    num_layers=5,
    d_model=320,
    d_ff=120,
    vocab_size=10,          # n_classes
    dtype="float32",
    remat=False,
    source="paper §V (LeNet-style)",
)
