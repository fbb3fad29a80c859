"""The port's roofline module against the reference's
``repro.roofline.analysis``: ``model_flops_per_step`` equal for every arch
(full and SMOKE) and kind, and ``roofline_terms`` equal when both are given
the same figures (the reference's v5e numbers carried into the port's
``HW``). The card table itself is read only on the card."""
import pytest

from repro import configs as JC
from repro.roofline import analysis as JRA
from repro_torch import configs as TC
from repro_torch.roofline import analysis as TRA


@pytest.mark.parametrize("arch", sorted(TC.ARCHS))
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_model_flops_per_step_matches_reference(arch, kind):
    for get_j, get_t in ((JC.get_config, TC.get_config),
                         (JC.get_smoke, TC.get_smoke)):
        for tokens in (1, 8192):
            assert TRA.model_flops_per_step(get_t(arch), tokens, kind) == \
                JRA.model_flops_per_step(get_j(arch), tokens, kind)


@pytest.mark.parametrize("chips,per_device", [(1, True), (4, True),
                                              (4, False)])
@pytest.mark.parametrize("flops,nbytes,coll", [(1e15, 2e11, 0.0),
                                               (3e12, 9e11, 5e9),
                                               (0.0, 0.0, 7e10)])
def test_roofline_terms_match_reference(chips, per_device, flops, nbytes,
                                        coll):
    v5e = JRA.V5E
    # the v5e has one matrix rate: roofline_terms reads only peak_flops
    hw = TRA.HW(peak_flops=v5e.peak_flops, hbm_bw=v5e.hbm_bw,
                link_bw=v5e.ici_bw, tf32_flops=v5e.peak_flops,
                fp32_flops=v5e.peak_flops, hbm_bytes=0.0)   # not read here
    want = JRA.roofline_terms(hlo_flops=flops, hlo_bytes=nbytes,
                              coll_bytes=coll, chips=chips,
                              per_device=per_device, hw=v5e)
    got = TRA.roofline_terms(flops=flops, nbytes=nbytes, coll_bytes=coll,
                             chips=chips, per_device=per_device, hw=hw)
    assert got == want


def test_unknown_card_has_no_figures():
    with pytest.raises(KeyError):
        TRA.hw_for("a card not in the table")
    h100 = TRA.hw_for("NVIDIA H100 80GB HBM3")
    assert (h100.peak_flops, h100.hbm_bw) == (989e12, 3.35e12)
    assert TRA.kernel_bound(3.35e12, 0.0, h100.fp32_flops, h100) == (
        1.0, "bytes")
    assert TRA.kernel_bound(0.0, 67e12, h100.fp32_flops, h100) == (
        1.0, "operations")
