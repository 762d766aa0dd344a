"""RWKV-6 "Finch" 3B: attention-free, data-dependent decay
[arXiv:2404.05892].

32L d_model=2560 (40 heads x 64), d_ff=8960, vocab=65536.
The port trains it federatedly on the pod path (``launch.train --pod``);
the time mix runs on the hand-written rwkv6 recurrence kernels. Decode
(``time_mix_step``) waits for the serving slice.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    num_layers=32,
    d_model=2560,
    d_ff=8960,
    vocab_size=65536,
    train_fsdp=True,
    fes_tail_layers=2,
    source="arXiv:2404.05892",
)
