"""``update_sync_ms``: ms a frame step in the update stage (the entry's
"update" function, ``STAGES`` in ``entries/<entry>.py``), with the card
synchronized before and after each call."""
from __future__ import annotations

from ._sync import stage_ms

ROLE = "update"


def read(ctx):
    return stage_ms(ctx, ROLE)
