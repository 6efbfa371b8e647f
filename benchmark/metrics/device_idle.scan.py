"""The share of the window in which no kernel, copy or set ran on the card,
in %."""


def read(m):
    if m.window_s <= 0:
        return None
    return (1.0 - m.busy_s() / m.window_s) * 100.0
