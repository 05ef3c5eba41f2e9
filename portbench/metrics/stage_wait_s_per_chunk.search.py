"""Seconds a chunk of the staging worker's wait (stageWait), from the engine's
chunk_budgets.jsonl."""

from ._budget import per_chunk


def read(ctx):
    return per_chunk(ctx, "stageWait")
