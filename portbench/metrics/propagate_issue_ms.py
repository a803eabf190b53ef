"""``propagate_issue_ms``: host ms a frame step inside the program's
``propagate`` spans (``pipeline.propagate_frame``), nothing synchronized,
over the traced run's device pass (``_spans``)."""
from __future__ import annotations

from ._spans import issue_ms

SPAN = "propagate"


def read(ctx):
    return issue_ms(ctx, SPAN)
