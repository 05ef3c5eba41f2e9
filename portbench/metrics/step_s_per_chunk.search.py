"""Seconds a chunk of the batched steps, each ending in a device
sync (step), from the engine's
chunk_budgets.jsonl."""

from ._budget import per_chunk


def read(ctx):
    return per_chunk(ctx, "step")
