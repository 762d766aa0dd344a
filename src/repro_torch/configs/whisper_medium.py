"""Whisper-medium [arXiv:2212.04356] — encoder-decoder, conv frontend stub.

24L (encoder) + 24L (decoder), d_model=1024, 16H MHA, d_ff=4096, vocab=51865.
mel+conv codec is a STUB: input_specs hands 1500 precomputed frame embeddings.
Plain (non-gated) GELU MLP as in the original. The port trains it
federatedly on the pod path (``launch.train --pod``: the encoder
non-causal over 1,500 frames, the decoder causal, its cross-attention
q of the tokens against the 1,500 frames' k, v, all on the flash
kernels) and serves it with the loop engine (``launch.serve``, chunked
prefill on; the cross-attention on serve_attention's cross form).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    num_layers=24,          # decoder depth
    encoder_layers=24,
    encoder_seq=1500,       # 30 s of audio at 50 Hz after conv stride
    d_model=1024,
    d_ff=4096,
    vocab_size=51865,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    mlp_gated=False,
    source="arXiv:2212.04356",
)
