"""Synthetic datasets (numpy; the port's copy of ``repro.data.synth``).

``make_image_classification`` generates an MNIST-shaped dataset
(28x28x1, 10 classes) whose classes are genuinely learnable but not
linearly trivial: each class is a random frequency-structured template +
per-sample random affine-ish jitter + noise. The FL-relevant properties of
the paper's setup — class structure, non-iid shardability, train/test
split — are preserved. ``make_lm_tokens`` generates the token streams
of the pod-scale LLM path: class-conditional first-order Markov chains
over an active vocabulary slice.
"""
from __future__ import annotations

import numpy as np


def make_image_classification(n_train: int = 6000, n_test: int = 1000,
                              n_classes: int = 10, seed: int = 0):
    rng = np.random.RandomState(seed)
    # class templates: smooth random fields (low-freq fourier mix)
    xs = np.linspace(0, 1, 28)
    xx, yy = np.meshgrid(xs, xs)
    templates = []
    for c in range(n_classes):
        t = np.zeros((28, 28))
        for _ in range(4):
            fx, fy = rng.randint(1, 5, size=2)
            ph = rng.rand(2) * 2 * np.pi
            t += rng.randn() * np.sin(2 * np.pi * fx * xx + ph[0]) \
                * np.sin(2 * np.pi * fy * yy + ph[1])
        templates.append(t / np.abs(t).max())
    templates = np.stack(templates)                       # (C, 28, 28)

    def gen(n):
        labels = rng.randint(0, n_classes, size=n)
        base = templates[labels]
        # per-sample jitter: random shift + scale + noise
        shift = rng.randint(-2, 3, size=(n, 2))
        imgs = np.empty((n, 28, 28), np.float32)
        for i in range(n):
            imgs[i] = np.roll(np.roll(base[i], shift[i, 0], 0), shift[i, 1], 1)
        imgs = imgs * (0.8 + 0.4 * rng.rand(n, 1, 1))
        imgs += 0.35 * rng.randn(n, 28, 28)
        return {"image": imgs[..., None].astype(np.float32),
                "label": labels.astype(np.int32)}

    return gen(n_train), gen(n_test)


def make_lm_tokens(n_seqs: int, seq_len: int, vocab: int, n_topics: int = 10,
                   seed: int = 0):
    """Class-conditional first-order Markov token streams."""
    rng = np.random.RandomState(seed)
    V = min(vocab, 1024)          # active vocab slice (rest unused)
    trans = rng.dirichlet(np.full(V, 0.05), size=(n_topics, V))   # (T, V, V)
    topics = rng.randint(0, n_topics, size=n_seqs)
    out = np.empty((n_seqs, seq_len), np.int32)
    for i in range(n_seqs):
        T = trans[topics[i]]
        tok = rng.randint(0, V)
        for j in range(seq_len):
            out[i, j] = tok
            tok = rng.choice(V, p=T[tok])
    return {"tokens": out, "label": topics.astype(np.int32)}
