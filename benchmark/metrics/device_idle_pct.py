"""Device: the share of the traced search's wall in which no kernel,
copy or fill ran on the card (100 minus the union of their intervals)."""


def read(rec):
    d = rec["device"]
    if d["busy_s"] <= 0 or d["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - d["busy_s"] / d["window_s"])
