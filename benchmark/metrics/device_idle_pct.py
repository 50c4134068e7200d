"""Share of the traced window in which no kernel or copy ran on the card."""


def read(run):
    s = run.summary
    if s.window_s <= 0:
        return None
    return (100.0 * (1.0 - s.busy_s / s.window_s), "%")
