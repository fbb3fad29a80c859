"""Collective profile (port of ``repro.roofline.profile``'s ranking):
the collectives a step issued, ranked by per-participant bytes.

:func:`top_collectives` reads a collective log
(``parallel/collectives.recording``) where the reference reads the
collectives of a compiled HLO module, and returns the reference's shapes:
the largest individual collectives and the bytes aggregated by (kind,
origin). The reference's ``main`` lowers a dry-run cell
(``launch/dryrun.lower_*``) first; the port's comes with its
``launch/dryrun.py``.
"""
from __future__ import annotations

import collections


def top_collectives(log, top: int = 15):
    """(rows, agg): ``rows`` the ``top`` largest collectives as (bytes,
    kind, axes, origin), largest first; ``agg`` the ``top`` largest
    ((kind, origin), bytes) sums over the whole log."""
    rows = sorted(((r.nbytes, r.kind, str(r.axes), r.origin)
                   for r in log), reverse=True)
    agg = collections.Counter()
    for b, kind, _, origin in rows:
        agg[(kind, origin)] += b
    return rows[:top], agg.most_common(top)
