"""The device's idle share of the traced window, %: 1 minus the union of
its busy intervals over the window."""


def read(ctx):
    t = ctx["trace"]
    if t is None or ctx["mix"]["kind"] != "backlog":
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
