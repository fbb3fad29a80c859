"""Roofline terms and model FLOPs on the card (port of the card-independent
part of ``repro.roofline.analysis``).

    compute    = FLOPs / (chips * peak FLOP/s)
    memory     = bytes / (chips * HBM bytes/s)
    collective = collective bytes / (chips * link bytes/s)

The card's figures come from :data:`CARDS`, keyed by the name
``torch.cuda.get_device_properties`` reports; a card that is not in the
table raises (there is no default card). ``peak_flops`` is the dense bf16
tensor-core rate, the one ``roofline_terms`` and a model-FLOP share of
peak use; ``tf32_flops`` and ``fp32_flops`` (the 32-bit rate outside the
tensor cores) bound kernels that compute in those types
(:func:`kernel_bound`). :func:`collective_bytes` sums a collective log
(``parallel/collectives.recording``: what the port's mesh code issues)
where the reference parses the collectives of its compiled HLO; the
reference's HLO cost analysis (FLOPs and bytes of a lowered step) waits
for ``launch/dryrun.py``.
"""
from __future__ import annotations

import dataclasses


from repro_torch.parallel.collectives import KINDS


@dataclasses.dataclass(frozen=True)
class HW:
    peak_flops: float      # dense bf16 tensor-core FLOP/s a card
    hbm_bw: float          # device memory bytes/s a card
    link_bw: float         # NVLink bytes/s a card, each way
    tf32_flops: float      # dense TF32 tensor-core FLOP/s a card
    fp32_flops: float      # 32-bit FLOP/s outside the tensor cores a card


# NVIDIA's data sheet (the SXM part, dense rates, at 700 W)
CARDS = {
    "NVIDIA H100 80GB HBM3": HW(peak_flops=989e12, hbm_bw=3.35e12,
                                link_bw=450e9, tf32_flops=494e12,
                                fp32_flops=67e12),
}


def hw_for(name: str) -> HW:
    """The figures of the card called ``name``; raises for a card not in
    :data:`CARDS`."""
    if name not in CARDS:
        raise KeyError(f"no roofline figures for the card {name!r} (known: "
                       f"{sorted(CARDS)})")
    return CARDS[name]


def device_hw(device=0) -> HW:
    """The figures of a CUDA card by the name it reports."""
    import torch
    return hw_for(torch.cuda.get_device_properties(device).name)


def collective_bytes(log) -> dict[str, int]:
    """Per-participant output bytes of a collective log
    (``parallel/collectives.Record`` s) by kind: the reference's five
    kinds (``all-reduce``, ``all-gather``, ``reduce-scatter``,
    ``all-to-all``, ``collective-permute``) plus ``total``, their sum. A
    ``broadcast`` (the port's copy of a home tensor to every coordinate,
    which the reference's compiled programs do not contain) is not
    counted."""
    out = {k: 0 for k in KINDS}
    for rec in log:
        if rec.kind in out:
            out[rec.kind] += rec.nbytes
    out["total"] = sum(out[k] for k in KINDS)
    return out


def roofline_terms(*, flops: float, nbytes: float, coll_bytes: float,
                   chips: int, per_device: bool = True, hw: HW) -> dict:
    """Three terms in seconds (+ dominant). ``per_device=True`` means the
    inputs already are one card's numbers; otherwise they are the whole
    program's and get divided by ``chips``."""
    div = 1 if per_device else chips
    compute = flops / div / hw.peak_flops
    memory = nbytes / div / hw.hbm_bw
    coll = coll_bytes / div / hw.link_bw
    terms = {"compute_s": compute, "memory_s": memory, "collective_s": coll}
    dominant = max(terms, key=terms.get)
    bound = max(compute, memory, coll)
    total = max(bound, 1e-30)
    return {
        **terms,
        "dominant": dominant,
        "bound_s": bound,
        "compute_fraction": compute / total,
    }


def kernel_bound(nbytes: float, flops: float, rate: float,
                 hw: HW) -> tuple[float, str]:
    """The least time in seconds one card takes to move ``nbytes`` (each
    input read once, each output written once) and do ``flops`` at
    ``rate`` FLOP/s, and which of the two bounds it."""
    t_b, t_o = nbytes / hw.hbm_bw, flops / rate
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def model_flops_per_step(cfg, tokens: int, kind: str = "train") -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE); decode uses D=1
    token per sequence. Train counts fwd+bwd (x3 of forward)."""
    n = cfg.active_param_count()
    per_tok = 2 * n
    if kind == "train":
        per_tok *= 3
    return per_tok * tokens


def peak_share(flops: float, seconds: float, hw: HW, chips: int = 1) -> float:
    """``flops`` done in ``seconds`` as a share of ``chips`` cards' bf16
    peak (a model-FLOP share when ``flops`` is
    :func:`model_flops_per_step`)."""
    return flops / seconds / (chips * hw.peak_flops)
