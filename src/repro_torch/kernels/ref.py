"""Plain PyTorch oracles composed from the kernels' plain versions (the
counterpart of ``repro.kernels.ref``)."""
from __future__ import annotations

import torch

from repro_torch.kernels import relscan as RS
from repro_torch.kernels.flash_attention import flash_attention_ref  # noqa: F401
from repro_torch.kernels.mamba_scan import mamba2_scan_ref  # noqa: F401
from repro_torch.kernels.paged_attention import paged_attention_ref  # noqa: F401


def relscan_ref(cols, valid, vals, *, ops, limit, want_ids=True):
    """Fused-conjunction oracle with the :func:`relscan.relscan` contract
    (batched over the rows of ``vals [w, nterms]``), built only from the
    plain versions, whatever the device."""
    mask, _, count = RS.scan_ref(cols, valid, vals, ops)
    if not want_ids:
        return None, None, mask, count
    ids, _ = RS.compact_ref(mask, limit)
    present = torch.arange(limit, dtype=torch.int32,
                           device=mask.device)[None, :] < count[:, None]
    return ids, present, mask, count
