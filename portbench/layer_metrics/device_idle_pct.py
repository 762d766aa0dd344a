"""device_idle_pct (device): the share of the traced window in which no
kernel, copy or set ran on the card (the union of their intervals)."""


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0 or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
