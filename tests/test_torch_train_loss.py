"""The port's training loss and gradients against the reference's, on the
CPU.

For the attention families (dense, moe, audio, vlm; the recurrent ones are
in tests/test_torch_train_loss_recurrent.py) in reduced fp32 configs, with
the reference's weights bridged into the port: `backbone.loss_fn` (mean
next-token cross-entropy, plus 0.01 x layer 0's load-balancing loss for
moe) against the reference's,
and every gradient leaf of torch autograd against `jax.value_and_grad` of
the reference's `loss_fn`. Both run the reference's training math: its
blocked attention and chunked scans, each layer recomputed in backward.
The training path reaches no kernel.
"""
import dataclasses

import numpy as np
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
from repro.models import backbone as rbb
from repro.models.layers import ExecConfig as RefExec
from repro.models.layers import moe_aux_loss as ref_aux
from repro_torch.models import backbone
from repro_torch.models.layers import TRAIN_EXEC, moe_aux_loss


@pytest.mark.parametrize("family", ["audio", "dense", "moe", "vlm"])
def test_loss_and_every_gradient_match_reference(family):
    rcfg, rparams, cfg, params = bridged(FAMILIES[family])
    jb, tb = batches(rcfg)
    want_loss, want_grads = ref_value_and_grad(rparams, jb, rcfg)
    loss, grads = port_value_and_grad(params, tb, cfg, TRAIN_EXEC)
    assert abs(loss - want_loss) / abs(want_loss) < TOL_LOSS
    errs = leaf_errors(grads, want_grads)
    worst = max(errs, key=errs.get)
    assert errs[worst] < TOL_GRAD, (worst, errs[worst])


def test_moe_aux_loss_matches_reference():
    rcfg, rparams, cfg, params = bridged("qwen2-moe-a2.7b")
    x = np.random.default_rng(1).normal(size=(2, 24, cfg.d_model)).astype(np.float32)
    want = float(ref_aux({k: v[0] for k, v in rparams["layers"]["moe"].items()
                          if not isinstance(v, dict)}, x, rcfg))
    got = float(moe_aux_loss(params["layers"][0]["moe"], torch.from_numpy(x), cfg))
    assert abs(got - want) / abs(want) < TOL_LOSS
    # and it is part of the loss: 0.01 x aux on the embeddings
    _, tb = batches(rcfg)
    with torch.no_grad():
        ce = backbone.cross_entropy(backbone.forward(params, tb, cfg, TRAIN_EXEC),
                                    tb["labels"], cfg.vocab_size)
        total = backbone.loss_fn(params, tb, cfg, TRAIN_EXEC)
        aux = moe_aux_loss(params["layers"][0]["moe"], backbone._embed_in(params, tb), cfg)
    assert float(total) == pytest.approx(float(ce + 0.01 * aux), rel=1e-6)
    assert float(aux) > 0


def test_blocked_attention_over_several_query_blocks_matches_reference():
    """S = 40 in query blocks of 16 (two whole blocks and a part): the
    reference pads the queries and masks every key; the port slices the keys
    causally and checkpoints each block. Same loss and gradients."""
    rcfg, rparams, cfg, params = bridged("yi-6b")
    jb, tb = batches(rcfg, seq=40)
    want_loss, want_grads = ref_value_and_grad(rparams, jb, rcfg, RefExec(q_block=16))
    ex = dataclasses.replace(TRAIN_EXEC, q_block=16)
    loss, grads = port_value_and_grad(params, tb, cfg, ex)
    assert abs(loss - want_loss) / abs(want_loss) < TOL_LOSS
    assert max(leaf_errors(grads, want_grads).values()) < TOL_GRAD
    # the blocks really ran: the one-block loss differs in summation order only
    with torch.no_grad():
        whole = backbone.loss_fn(params, tb, cfg, TRAIN_EXEC)
    assert float(whole) == pytest.approx(loss, rel=1e-5)


def test_forward_logits_match_reference():
    rcfg, rparams, cfg, params = bridged("qwen2-vl-72b")
    jb, tb = batches(rcfg)
    want = np.asarray(rbb.forward(rparams, jb, rcfg))
    with torch.no_grad():
        got = backbone.forward(params, tb, cfg, TRAIN_EXEC).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-5


def test_the_kernel_front_door_refuses_inputs_that_require_a_gradient():
    """No kernel has a backward pass (the reference has none either), so
    the front door refuses an input that requires a gradient while autograd
    records, on the CPU too and under either impl; the training path never
    reaches it."""
    from repro_torch.kernels import ops

    q = torch.randn(1, 8, 2, 32)
    qg = q.clone().requires_grad_()
    for impl in ("auto", "torch"):
        with pytest.raises(RuntimeError, match="no backward"):
            ops.flash_attention(qg, q, q, impl=impl)
    with torch.no_grad():
        assert torch.equal(ops.flash_attention(qg, q, q), ops.flash_attention(q, q, q))
    r = torch.randn(1, 4, 2, 32)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.rwkv6_wkv(r, r, r, -r.abs(), torch.zeros(2, 32, requires_grad=True))
    with pytest.raises(RuntimeError, match="no backward"):
        ops.mamba2_ssd(r, r[..., 0, :], r[..., 0, :], r[..., 0].abs().requires_grad_(),
                       torch.zeros(2))
