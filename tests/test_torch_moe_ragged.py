"""The two MoE decoders' serving engines (granite-moe-1b, phi3.5-moe
SMOKE) against the reference's engine on the CPU with the ragged dispatch:
``REPRO_MOE_RAGGED=1`` set for both packages (the reference reads it at
its engine's traces, the port at every call), then the stream of
``test_torch_moe_engine.py`` with the same checks: equal greedy tokens,
logits within 1e-4, equal block counts and page tables. An expert's
capacity is ``min(max(8, int(1.25 n k / e)), n)`` rows: every token in
the 4-token rounds, 9 of the 15-token prefill's."""
import pytest

from _torch_pair import engine_stream, smoke_weights


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "phi3.5-moe-42b-a6.6b"])
def test_ragged_engine_matches_reference_engine(arch, monkeypatch):
    monkeypatch.setenv("REPRO_MOE_RAGGED", "1")
    pr = engine_stream(smoke_weights(arch))
    assert pr.counts == (3, 6, 2)
