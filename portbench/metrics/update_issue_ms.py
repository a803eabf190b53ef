"""``update_issue_ms``: host ms a frame step inside the program's
``update`` spans (``pipeline.update_step``), nothing synchronized, over
the traced run's device pass (``_spans``)."""
from __future__ import annotations

from ._spans import issue_ms

SPAN = "update"


def read(ctx):
    return issue_ms(ctx, SPAN)
