"""The two MoE decoders' serving engines (granite-moe-1b, phi3.5-moe
SMOKE) against the reference's engine on the CPU, with the dense dispatch
(the reference's default): the reference's weights carried across, 8
rounds in lockstep with equal greedy tokens, logits within 1e-4 (fp32:
summation order, and the port's write-then-attend island against the
reference's self term) and equal block counts and page tables after every
statement. ``test_torch_moe_ragged.py`` runs the same stream with
``REPRO_MOE_RAGGED=1``."""
import pytest

from _torch_pair import engine_stream, smoke_weights


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "phi3.5-moe-42b-a6.6b"])
def test_engine_matches_reference_engine(arch):
    """``_torch_pair.engine_stream``: 3 blocks freed by finish_request (9
    + 8 tokens), 4 + 2 by evict_user (25, 11), 2 by flush (10)."""
    pr = engine_stream(smoke_weights(arch))
    assert pr.counts == (3, 6, 2)
