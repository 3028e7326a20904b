"""Batches that replayed a captured program, over the batches the
window dispatched, in % (CapturedPrograms.replays). A capture or an
eager batch inside the window lowers it."""


def read(ctx):
    w = ctx["window"]
    if ctx["mix"]["kind"] != "backlog" or not ctx["graphs"] or not w.get("batches"):
        return None
    return 100.0 * w["replays"] / w["batches"]
