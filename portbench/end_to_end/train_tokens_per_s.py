"""train_tokens_per_s: every token the window's rounds trained (rounds x
C x steps x b x S) over the window's seconds, on the host clock; the
window closes when a round ends past ``--seconds``."""


def read(run):
    return run.tokens_per_round * len(run.round_s) / run.window_s
