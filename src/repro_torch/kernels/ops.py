"""The fused-scan entry point the table executors call (counterpart of
``repro.kernels.ops.predicate_scan``). There is no mode switch: the
relscan wrappers take their plain version for a CPU tensor and launch
their CUDA kernel for a CUDA tensor (``kernels/_build.py``). The hash
index kernels are called straight from ``kernels/hashidx.py``."""
from __future__ import annotations

from repro_torch.kernels import relscan as _relscan


def predicate_scan(cols, valid, vals, *, ops, limit, want_ids=True):
    """Fused WHERE scan + compaction for a conjunction of up to 4
    equality/range terms over int32 columns.

    ``vals`` is [nterms] (one statement: outputs carry no batch axis, the
    reference contract) or [w, nterms] (w statements in one launch:
    outputs lead with w). Returns (ids, present, mask, count); see
    :func:`repro_torch.kernels.relscan.relscan`."""
    single = vals.dim() == 1
    ids, present, mask, count = _relscan.relscan(
        cols, valid, vals[None] if single else vals, ops=tuple(ops),
        limit=limit, want_ids=want_ids)
    if not single:
        return ids, present, mask, count
    return (None if ids is None else ids[0],
            None if present is None else present[0], mask[0], count[0])
