"""Wall seconds a pass spends in its tail: the optimal catalog's merge and
duplicate removal (``pass.catalog_merge``), the area and flag mask files
(``pass.mask_files``) and the filter-cache writer's flush
(``loop.writer_flush``), over the window's ``pass`` spans."""

from ._spans import spans, wall


def read(ctx):
    passes = spans(ctx, "pass")
    if not passes:
        return None
    return wall(spans(ctx, "pass.catalog_merge", "pass.mask_files",
                      "loop.writer_flush")) / len(passes)
