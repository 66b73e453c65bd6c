"""The port's training loss and gradients against the reference's for the
recurrent families (ssm: RWKV6, hybrid: Mamba2 with a shared attention
block), on the CPU; and remat on and off.

Reduced fp32 configs with the reference's weights bridged into the port,
as tests/test_torch_train_loss.py. The chunked scans are the reference's
non-kernel forms, differentiated by torch autograd.
"""
import dataclasses

import pytest
import torch

from _torch_train_cases import (
    FAMILIES,
    TOL_GRAD,
    TOL_LOSS,
    batches,
    bridged,
    leaf_errors,
    port_value_and_grad,
    ref_value_and_grad,
)
from repro_torch.models.layers import TRAIN_EXEC


# the hybrid at 2 layers: one tap group (two Mamba2 layers, then the shared
# attention), half the reference's compile of the default 4
LAYERS = {"hybrid": 2, "ssm": 2}


@pytest.mark.parametrize("family", ["hybrid", "ssm"])
def test_loss_and_every_gradient_match_reference(family):
    rcfg, rparams, cfg, params = bridged(FAMILIES[family], num_layers=LAYERS[family])
    jb, tb = batches(rcfg)
    want_loss, want_grads = ref_value_and_grad(rparams, jb, rcfg)
    loss, grads = port_value_and_grad(params, tb, cfg, TRAIN_EXEC)
    assert abs(loss - want_loss) / abs(want_loss) < TOL_LOSS
    errs = leaf_errors(grads, want_grads)
    worst = max(errs, key=errs.get)
    assert errs[worst] < TOL_GRAD, (worst, errs[worst])


@pytest.mark.parametrize("family", ["dense", "hybrid"])
def test_remat_on_and_off_give_the_same_gradients(family):
    rcfg, _, cfg, params = bridged(FAMILIES[family])
    _, tb = batches(rcfg)
    _, on = port_value_and_grad(params, tb, cfg, TRAIN_EXEC)
    _, off = port_value_and_grad(params, tb, cfg, dataclasses.replace(TRAIN_EXEC, remat=False))
    errs = leaf_errors(on, off)
    assert max(errs.values()) == 0.0, max(errs.items(), key=lambda kv: kv[1])
