"""Seconds to load the corpus into the store: the records made through
the system's ingest (ChunkRecord, featurize_chunk) and ChunkStore.bulk_load,
the card waited for after it (benchmark spans)."""


def read(ctx):
    st = ctx["stages"]
    if "bulk_load" not in st:
        return None
    return st["records"] + st["bulk_load"]
