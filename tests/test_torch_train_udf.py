"""``test_torch_train.py``'s parity of one teacher-forced step with the
UDF mask head on (its loss over the candidate hierarchy and the UDF
decoder's gradients), at the same configuration and tolerances."""

import pytest

from test_torch_train import (check_grads, check_loss_terms,
                              check_solves_converged, check_unet, run_parity)


@pytest.fixture(scope="module")
def parity():
    mp = pytest.MonkeyPatch()
    try:
        yield run_parity(True, mp)
    finally:
        mp.undo()


def test_solves_converged(parity):
    check_solves_converged(parity)


def test_loss_terms_match_jax(parity):
    assert "udf" in parity["losses"]
    check_loss_terms(parity)


def test_grads_match_jax(parity):
    check_grads(parity)


def test_unet_outputs_match_jax(parity):
    check_unet(parity)
