"""Phi-3-vision 4.2B [hf:microsoft/Phi-3-vision-128k-instruct].

32L d_model=3072 32H (kv=32, MHA) d_ff=8192 vocab=32064.
Vision frontend (CLIP ViT) is a STUB per the assignment: input_specs hands
the decoder precomputed patch embeddings (projected in-model). The port
trains it federatedly on the pod path (``launch.train --pod``: 576
patches before 2,048 tokens, 2,624 rows through the flash kernels at
hd 96) and serves it on tokens alone, as the dense family serves
(``launch.serve``, the paged and loop engines).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    num_layers=32,
    d_model=3072,
    d_ff=8192,
    vocab_size=32064,
    num_heads=32,
    num_kv_heads=32,
    head_dim=96,
    num_patches=576,        # 24x24 CLIP-L/14 grid @336px
    vision_dim=1024,        # CLIP ViT-L hidden size
    train_fsdp=True,
    source="hf:microsoft/Phi-3-vision-128k-instruct",
)
