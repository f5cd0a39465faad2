"""``loss_fn``'s value and every parameter's gradient against
``jax.value_and_grad`` of the reference, f32 on the CPU, on the MLA
(DeepSeek-V2), MoE (DeepSeek-MoE), encoder-decoder (whisper, with
frames) and vision-prefix (InternVL2, with patches) smoke configs, and
two MoE routing groups against the reference's.  Helpers and tolerances
are those of ``test_torch_train_grads.py``."""

from __future__ import annotations

import pytest

pytest.importorskip("torch")

from test_torch_train_grads import (FAMILIES,  # noqa: E402,F401
                                    check_loss_and_grads, make_batch,
                                    check_remat, port_value_and_grad, smoke)


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_fn_value_and_grads_match_reference(smoke, arch):
    check_loss_and_grads(smoke, arch)


def test_moe_groups_match_reference(smoke):
    """Two routing groups of B·S / 2 tokens each, with their own capacity
    and the aux loss averaged over groups, on both sides; the grouping
    changes the loss."""
    _, tcfg, tree = smoke("deepseek-moe-16b")
    one_group, _ = port_value_and_grad(tree, tcfg, make_batch(tcfg))
    assert check_loss_and_grads(smoke, "deepseek-moe-16b",
                                moe_groups=2) != one_group


def test_remat_changes_neither_loss_nor_grads(smoke):
    check_remat(smoke, "deepseek-v2-236b")
