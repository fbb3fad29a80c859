"""The port's training loss and gradients against the reference's on the
CPU, for the SMOKE configs with a frontend (internvl2-1b), a Mamba1 stack
(falcon-mamba-7b) and Mamba2 layers with the shared block (zamba2-2.7b):
the loss within 1e-5, each gradient leaf within 1e-4 of its largest entry
(``tests/_torch_train.py``; the other families are in
``test_torch_train_loss.py``)."""
import pytest

from _torch_train import check_loss_and_grads


@pytest.mark.parametrize("arch", ["internvl2-1b", "falcon-mamba-7b",
                                  "zamba2-2.7b"])
def test_train_loss_and_grads_match_reference(arch):
    check_loss_and_grads(arch)
