"""Minitron-8B — pruned Nemotron-4 [arXiv:2407.14679].

32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000.
Dense full attention. The port trains it federatedly on the pod path
(``launch.train --pod``) and serves its beyond-paper long-context
variant, ``CONFIG_SWA`` (a sliding window of 4096 over a ring cache),
through ``launch.serve``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    d_ff=16384,
    vocab_size=256000,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    train_fsdp=True,
    source="arXiv:2407.14679",
)

# beyond-paper long-context serving variant (sliding window)
CONFIG_SWA = CONFIG.with_(sliding_window=4096)
