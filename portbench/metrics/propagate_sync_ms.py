"""``propagate_sync_ms``: ms a frame step in the propagate stage (the entry's
"propagate" function, ``STAGES`` in ``entries/<entry>.py``), with the card
synchronized before and after each call."""
from __future__ import annotations

from ._sync import stage_ms

ROLE = "propagate"


def read(ctx):
    return stage_ms(ctx, ROLE)
