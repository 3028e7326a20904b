"""Device busy time per batch, ms: the union of the traced window's
device intervals over the batches it ran."""


def read(ctx):
    t, w = ctx["trace"], ctx["window"]
    if t is None or ctx["mix"]["kind"] != "backlog" or not w.get("batches"):
        return None
    return 1e3 * t["busy_s"] / w["batches"]
