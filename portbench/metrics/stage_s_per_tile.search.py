"""Wall seconds the staging worker spends on a tile: the program's
``stage.tile`` spans in the window, over their count."""

from ._spans import spans, wall


def read(ctx):
    found = spans(ctx, "stage.tile")
    if not found:
        return None
    return wall(found) / len(found)
