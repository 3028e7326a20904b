"""Seconds of the ANN build (SearchEngine.ensure_ann: k-means, the
residual PCA and the proj encoding), the card waited for after it
(benchmark span). Nothing to read under the exact backend."""


def read(ctx):
    if ctx["shape"]["backend"] == "exact" or "ann_build" not in ctx["stages"]:
        return None
    return ctx["stages"]["ann_build"]
