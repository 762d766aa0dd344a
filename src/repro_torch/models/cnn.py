"""The paper's own task model: 2 conv (5x5) + 3 FC layers for 28x28 images.

FES split as in the paper: feature extractor = the conv layers (under
``body``), classifier = the three FC layers. Params keep the JAX
layouts: HWIO conv weights and ``(d_in, d_out)`` dense weights, so the
trees (and the server plane's flat vectors) match the JAX package's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import cross_entropy_loss, dense, dense_init
from repro_torch.utils.tree import tree_map


def init_params(cfg, gen: torch.Generator, device=None) -> dict:
    """The JAX package's shapes and distributions, drawn from ``gen``
    on the CPU (so a seed gives the same params on every device)."""
    c1, c2 = 10, 20
    p = {
        # feature extractor (conv) — paper's omega^f
        "body": {
            "conv1": {"w": 0.1 * torch.randn((5, 5, 1, c1), generator=gen)},
            "conv2": {"w": 0.1 * torch.randn((5, 5, c1, c2), generator=gen)},
        },
        # classifier (3 FC) — paper's omega^c
        "fc1": dense_init(gen, 4 * 4 * c2, 120, torch.float32, bias=True),
        "fc2": dense_init(gen, 120, 84, torch.float32, bias=True),
        "fc3": dense_init(gen, 84, cfg.vocab_size, torch.float32, bias=True),
    }
    return tree_map(lambda x: x.to(device), p)


def _conv(x_nchw, w_hwio):
    """VALID 2-D convolution of an NCHW input by an HWIO weight."""
    return F.conv2d(x_nchw, w_hwio.permute(3, 2, 0, 1))


def forward(params, cfg, batch):
    """batch: {"image": (B, 28, 28, 1)} NHWC -> logits (B, n_classes)."""
    x = batch["image"].float().permute(0, 3, 1, 2)               # NCHW
    x = F.relu(_conv(x, params["body"]["conv1"]["w"]))           # (B,10,24,24)
    x = F.max_pool2d(x, 2, 2)
    x = F.relu(_conv(x, params["body"]["conv2"]["w"]))           # (B,20,8,8)
    x = F.max_pool2d(x, 2, 2)
    # flatten in NHWC order, as the JAX model does: fc1's 320 rows are
    # ordered h*80 + w*20 + c
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)            # (B, 320)
    x = F.relu(dense(params["fc1"], x))
    x = F.relu(dense(params["fc2"], x))
    return dense(params["fc3"], x), 0.0


def loss_fn(params, cfg, batch):
    logits, _ = forward(params, cfg, batch)
    return cross_entropy_loss(logits, batch["label"])
