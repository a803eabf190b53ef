"""``idle_in_propagate_pct``: of the device pass's idle time (the gaps in
the union of its device events, within their span), the share during
which the host was inside one of the pass's ``propagate`` spans
(``_spans``)."""
from __future__ import annotations

from ._spans import idle_share_in

SPAN = "propagate"


def read(ctx):
    return idle_share_in(ctx, SPAN)
