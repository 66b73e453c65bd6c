"""The port's optimizer and train step against the reference's, on the CPU.

- AdamW (`optimizer.apply_updates`): three steps on the same params and
  gradients as the reference's, every state leaf compared.
- Microbatch accumulation: 2 microbatches give the loss and gradients of 1
  (positions, (3, B, S) under M-RoPE, split on dim 1).
- One `train_step` for reduced yi-6b and llama-300m (tied embeddings):
  params and optimizer state against the reference's train_step. Its
  gradients are cast to bf16 before the update (the reference pins its
  gradient sync to bf16), so where the two frameworks' fp32 gradients differ
  by an ulp the bf16 rounding can flip one way on one side: the test counts
  those flips and bounds them, and bounds the params in units of lr.
"""
import copy

import jax
import jax.numpy as jnp
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
    np_tree,
    ref_value_and_grad,
    to_reference,
)
from repro.training import optimizer as ropt
from repro.training.train_step import train_step as ref_train_step
from repro_torch.models.layers import TRAIN_EXEC
from repro_torch.training.optimizer import AdamWConfig, apply_updates, init_opt_state, tree_map
from repro_torch.training.train_step import loss_and_grads, train_step
from repro_torch.weights import from_reference

LR = 1e-3
# the params after one step, max |port - reference| in units of lr (a step
# moves an element by about lr); the moments, per leaf, relative to the
# leaf's largest magnitude (a bf16 flip moves one element by 2^-8 of it)
TOL_PARAMS_LR = 0.1
TOL_MOMENTS = 1e-2
# bf16 rounding flips of the gradients: at most this share of the elements
MAX_FLIP_SHARE = 5e-3


def _opt_cfgs(**kw):
    return ropt.AdamWConfig(**kw), AdamWConfig(**kw)


def test_three_adamw_steps_match_reference():
    rcfg, rparams, cfg, _ = bridged("llama-300m", dtype="bfloat16")
    rng = np.random.default_rng(3)
    rcfg_opt, cfg_opt = _opt_cfgs(lr=LR, warmup_steps=2, grad_clip=0.5)
    rp = jax.tree.map(jnp.asarray, rparams)
    rstate = ropt.init_opt_state(rp)
    ref_apply = jax.jit(ropt.apply_updates, static_argnums=0)
    params = from_reference(rparams, cfg, device="cpu")
    state = init_opt_state(params)
    for step in range(3):
        # bf16 gradients, as train_step hands them over; the last step's
        # small enough that no clipping happens
        g = jax.tree.map(lambda a: (rng.normal(size=a.shape) * (0.3 if step < 2 else 1e-4))
                         .astype(np.float32), rparams)
        gj = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), g)
        rp, rstate, rmet = ref_apply(rcfg_opt, rp, gj, rstate)
        gt = from_reference(np_tree(gj), cfg, device="cpu")
        params, state, met = apply_updates(cfg_opt, params, gt, state)
        # a sum of squares over every element, in another order
        assert float(met["grad_norm"]) == pytest.approx(float(rmet["grad_norm"]), rel=1e-5)
        assert float(met["lr"]) == float(rmet["lr"])
    assert int(state["step"]) == int(rstate["step"]) == 3
    got, want = to_reference(state, cfg), np_tree(rstate)
    for k in ("m", "v", "master"):
        errs = leaf_errors(got[k], want[k])
        assert max(errs.values()) < 1e-5, (k, max(errs.items(), key=lambda kv: kv[1]))
    # params are the master cast to bf16: equal where the masters are
    errs = leaf_errors(to_reference(params, cfg), np_tree(rp))
    assert max(errs.values()) < 1e-2


@pytest.mark.parametrize("family", ["dense", "vlm"])
def test_two_microbatches_give_the_loss_and_gradients_of_one(family):
    rcfg, _, cfg, params = bridged(FAMILIES[family])
    _, tb = batches(rcfg, batch=4, seq=16)
    loss1, g1 = loss_and_grads(params, tb, cfg, TRAIN_EXEC, microbatches=1)
    loss2, g2 = loss_and_grads(params, tb, cfg, TRAIN_EXEC, microbatches=2)
    assert abs(float(loss2) - float(loss1)) / abs(float(loss1)) < TOL_LOSS
    errs = leaf_errors(to_reference(g2, cfg), to_reference(g1, cfg))
    assert max(errs.values()) < TOL_GRAD
    assert all(g.dtype == torch.float32 for g in jax.tree.leaves(g2))    # accumulated in fp32


@pytest.mark.parametrize("arch", ["yi-6b", "llama-300m"])
def test_one_train_step_matches_reference(arch):
    rcfg, rparams, cfg, params = bridged(arch)
    jb, tb = batches(rcfg, batch=2, seq=16)
    rcfg_opt, cfg_opt = _opt_cfgs(lr=LR, warmup_steps=1)
    rp = jax.tree.map(jnp.asarray, rparams)
    rp2, rstate, rmet = jax.jit(ref_train_step, static_argnums=(3, 4))(
        rp, ropt.init_opt_state(rp), jb, rcfg, rcfg_opt)
    params = copy.deepcopy(params)
    p2, state, met = train_step(params, init_opt_state(params), tb, cfg, cfg_opt, TRAIN_EXEC)
    assert abs(float(met["loss"]) - float(rmet["loss"])) / float(rmet["loss"]) < TOL_LOSS
    assert float(met["grad_norm"]) == pytest.approx(float(rmet["grad_norm"]), rel=1e-5)
    assert float(met["lr"]) == float(rmet["lr"]) and int(state["step"]) == 1

    # the bf16 rounding flips: the same fp32 gradients on both sides, cast
    _, rg = ref_value_and_grad(rparams, jb, rcfg)
    _, g = loss_and_grads(from_reference(rparams, cfg, device="cpu"), tb, cfg, TRAIN_EXEC)
    g = to_reference(tree_map(lambda t: t.to(torch.bfloat16), g), cfg)
    rgb = jax.tree.map(lambda a: np.asarray(jnp.asarray(a).astype(jnp.bfloat16), np.float32), rg)
    flips = sum(int((g_ != w).sum()) for g_, w in zip(jax.tree.leaves(g), jax.tree.leaves(rgb)))
    total = sum(w.size for w in jax.tree.leaves(rgb))
    print(f"{arch}: {flips} of {total} bf16 gradient elements round the other way")
    assert flips <= MAX_FLIP_SHARE * total

    got, want = to_reference(state, cfg), np_tree(rstate)
    for k in ("m", "v"):
        errs = leaf_errors(got[k], want[k])
        assert max(errs.values()) < TOL_MOMENTS, (k, max(errs.items(), key=lambda kv: kv[1]))
    for name, got_t, want_t in (("master", got["master"], want["master"]),
                                ("params", to_reference(p2, cfg), np_tree(rp2))):
        diff = max(float(np.abs(a - b).max()) for a, b in
                   zip(jax.tree.leaves(got_t), jax.tree.leaves(want_t)))
        assert diff < TOL_PARAMS_LR * LR, (name, diff / LR)
