"""Seconds a chunk of host emission and catalog work (download + consume
+ hostOther), from the engine's chunk_budgets.jsonl."""

from ._budget import per_chunk


def read(ctx):
    return per_chunk(ctx, "download", "consume", "hostOther")
