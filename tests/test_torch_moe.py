"""The port's mixture of experts against the reference's, on the CPU.

`moe_ffn`: the reference's weights (`init_moe` from a PRNGKey) carried over
exactly, the same numpy input through both, in fp32 and bf16, in one group
and in several; one case whose capacity drops units (the test counts the
drops from the routing, so the overflow path is really taken) and one with
capacity_factor = E, which drops none. The reference's identical-experts
property (tests/test_property.py) holds in the port: with every expert the
same and room for every unit, the MoE is that expert's SwiGLU.

Backbone: reduced qwen2-moe-a2.7b with the reference's weights bridged by
`from_reference`; logits and caches of prefill, serve_step, serve_step_paged
and extend_step against the reference under both of the port's exec configs
(the kernels' plain versions, and the reference's blocked math), and a bf16
prefill. `from_reference` keeps the router in fp32 and the experts in the
config's dtype.

Tolerances (max|a - b| / max|b|) are tests/test_torch_model.py's: 1e-4 in
fp32 (summation order only), 5e-2 in bf16.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from _torch_family_cases import TOL, assert_cache_close, bridged, rel_err
from repro.models import backbone as rbb
from repro.models import layers as rlayers
from repro.serving.kv_cache import PagedKVPool as RefPool
from repro_torch.configs import get_reduced_config
from repro_torch.models import backbone, layers
from repro_torch.models.layers import ExecConfig
from repro_torch.serving.kv_cache import PagedKVPool

ARCH = "qwen2-moe-a2.7b"
EXECS = {"kernels": ExecConfig(), "blocked": ExecConfig(use_kernels=False)}
# (capacity_factor or None for the config's, moe_group_size, whether units drop)
MOE_CASES = {"drops": (0.5, 4096, True), "no-drop": ("E", 4096, False),
             "groups": (None, 8, None)}


def _moe_cfg(dtype, cf):
    cfg = get_reduced_config(ARCH, dtype=dtype)
    if cf is not None:
        m = cfg.moe
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            m, capacity_factor=float(m.num_experts) if cf == "E" else cf))
    return cfg


def _dropped_units(x, router, cfg, group) -> int:
    """Units past their expert's capacity, from fp32 routing in numpy."""
    m = cfg.moe
    xg = x.reshape(-1, min(group, x.shape[0] * x.shape[1]), x.shape[-1])
    logits = xg @ router
    top = np.argsort(-logits, axis=-1, kind="stable")[..., :m.top_k]
    cap = layers._moe_capacity(xg.shape[1], m)
    counts = np.stack([np.bincount(t.ravel(), minlength=m.num_experts) for t in top])
    return int(np.maximum(counts - cap, 0).sum())


def _bridge(rp: dict) -> dict:
    """The reference's MoE weights in torch, each in its own dtype (exact:
    bf16 widens to fp32 and back)."""
    def cast(a):
        return torch.from_numpy(np.array(a, np.float32)).to(getattr(torch, a.dtype.name))

    return {k: _bridge(v) if isinstance(v, dict) else cast(v) for k, v in rp.items()}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
@pytest.mark.parametrize("dtype", sorted(TOL))
def test_moe_ffn_matches_reference(dtype, case):
    cf, group, drops = MOE_CASES[case]
    cfg = _moe_cfg(dtype, cf)
    rp = rlayers.init_moe(jax.random.PRNGKey(7), cfg)
    p = _bridge(rp)
    x = np.random.default_rng(2).standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    want = rlayers.moe_ffn(rp, jnp.asarray(x).astype(dtype), cfg,
                           rlayers.ExecConfig(moe_group_size=group))
    got = layers.moe_ffn(p, torch.from_numpy(x).to(getattr(torch, dtype)), cfg,
                         ExecConfig(moe_group_size=group))
    assert got.dtype == getattr(torch, dtype) and got.shape == x.shape
    assert rel_err(got, want) < TOL[dtype]
    dropped = _dropped_units(x, np.asarray(rp["router"]), cfg, group)
    if drops is not None:
        assert (dropped > 0) is drops, dropped


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(0, 100))
def test_identical_experts_equal_swiglu(seed):
    """With capacity >= tokens, MoE with identical experts equals the plain
    swiglu with the same weights (routing becomes irrelevant)."""
    cfg = get_reduced_config(ARCH)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, num_experts=4, top_k=1, capacity_factor=4.0, num_shared_experts=0))
    p = layers.init_moe(torch.Generator().manual_seed(seed), cfg)
    for k in ("w_gate", "w_up", "w_down"):
        p[k] = p[k][:1].expand_as(p[k]).contiguous()
    x = torch.randn(2, 16, cfg.d_model, generator=torch.Generator().manual_seed(seed + 1))
    x = x.to(torch.bfloat16)
    out = layers.moe_ffn(p, x, cfg)
    want = layers.swiglu({k: p[k][0] for k in ("w_gate", "w_up", "w_down")}, x)
    assert rel_err(out, want) < 0.05


# ---------------------------------------------------------------- backbone
@pytest.fixture(scope="module")
def model():
    rcfg, rparams, cfg, params = bridged(ARCH)
    tokens = np.random.default_rng(5).integers(1, cfg.vocab_size, size=(2, 19)).astype(np.int32)
    return dict(cfg=cfg, rcfg=rcfg, params=params, rparams=rparams, tokens=tokens,
                rng=np.random.default_rng(6))


def _prefill_both(m, ex):
    want = rbb.prefill(m["rparams"], {"tokens": m["tokens"]}, m["rcfg"])
    got = backbone.prefill(m["params"], {"tokens": torch.from_numpy(m["tokens"])}, m["cfg"], ex)
    return got, want




@pytest.mark.parametrize("exec_name", sorted(EXECS))
def test_prefill_matches_reference(model, exec_name):
    (gl, gc), (wl, wc) = _prefill_both(model, EXECS[exec_name])
    assert rel_err(gl, wl) < TOL["float32"]
    assert_cache_close(gc, wc)


@pytest.mark.parametrize("exec_name", sorted(EXECS))
def test_serve_and_extend_steps_match_reference(model, exec_name):
    ex, tol = EXECS[exec_name], TOL["float32"]
    (_, gc), (_, wc) = _prefill_both(model, ex)
    pad = 8
    wc = rbb._grow_cache(wc, model["rcfg"], model["tokens"].shape[1] + pad)
    gc = backbone._grow_cache(gc, model["cfg"], model["tokens"].shape[1] + pad)
    nxt = model["rng"].integers(1, model["cfg"].vocab_size, size=(2,)).astype(np.int32)
    wl, wc = rbb.serve_step(model["rparams"], wc, nxt, model["rcfg"])
    gl, gc = backbone.serve_step(model["params"], gc, torch.from_numpy(nxt), model["cfg"], ex)
    assert rel_err(gl, wl) < tol
    assert_cache_close(gc, wc)
    ext = model["rng"].integers(1, model["cfg"].vocab_size, size=(2, 3)).astype(np.int32)
    wl, wc = rbb.extend_step(model["rparams"], wc, ext, model["rcfg"])
    gl, gc = backbone.extend_step(model["params"], gc, torch.from_numpy(ext), model["cfg"], ex)
    assert gl.shape == (2, 3, model["cfg"].vocab_size)
    assert rel_err(gl, wl) < tol
    assert_cache_close(gc, wc)


def test_serve_step_paged_matches_reference(model):
    lengths = [19, 14]
    (_, gc), (_, wc) = _prefill_both(model, ExecConfig())
    rpool = RefPool(model["rcfg"], 16, 8, dtype=jnp.float32)
    pool = PagedKVPool(model["cfg"], 16, 8, dtype=torch.float32)
    for sid, n in enumerate(lengths):
        rpool.allocate(sid, n)
        rpool.scatter([sid], wc["k"][:, sid:sid + 1, :, :n], wc["v"][:, sid:sid + 1, :, :n])
        pool.allocate(sid, n)
        pool.scatter([sid], gc["k"][:, sid:sid + 1, :, :n], gc["v"][:, sid:sid + 1, :, :n])
    max_len = max(lengths) + 1
    nb = pool.blocks_needed(max_len)
    nxt = model["rng"].integers(1, model["cfg"].vocab_size, size=(2,)).astype(np.int32)
    wl, wk, wv = rbb.serve_step_paged(
        model["rparams"], rpool.k, rpool.v, rpool.device_tables([0, 1], nb),
        jnp.asarray(lengths, jnp.int32), nxt, model["rcfg"], max_len=max_len, impl="jnp")
    gl, gk, gv = backbone.serve_step_paged(
        model["params"], pool.k, pool.v, pool.device_tables([0, 1], nb),
        torch.tensor(lengths, dtype=torch.int32), torch.from_numpy(nxt), model["cfg"],
        max_len=max_len)
    tol = TOL["float32"]
    assert rel_err(gl, wl) < tol
    assert rel_err(gk, wk) < tol and rel_err(gv, wv) < tol


def test_prefill_chunk_paged_stays_dense_only(model):
    with pytest.raises(ValueError, match="'dense',"):
        backbone.prefill_chunk_paged(None, None, None, None, 0, None, model["cfg"])


def test_bf16_prefill_matches_reference():
    rcfg, rparams, cfg, params = bridged(ARCH, "bfloat16")
    tokens = np.random.default_rng(5).integers(1, cfg.vocab_size, size=(2, 19)).astype(np.int32)
    wl, _ = rbb.prefill(rparams, {"tokens": tokens}, rcfg)
    gl, _ = backbone.prefill(params, {"tokens": torch.from_numpy(tokens)}, cfg)
    assert gl.dtype == torch.bfloat16 and torch.isfinite(gl.float()).all()
    assert rel_err(gl, wl) < TOL["bfloat16"]


def test_from_reference_keeps_the_router_fp32():
    _, rparams, cfg, params = bridged(ARCH, "bfloat16")
    for l, lp in enumerate(params["layers"]):
        moe = lp["moe"]
        assert moe["router"].dtype == torch.float32
        assert {moe[k].dtype for k in ("w_gate", "w_up", "w_down")} == {torch.bfloat16}
        assert moe["shared"]["w_gate"].dtype == torch.bfloat16
        want = np.asarray(rparams["layers"]["moe"]["router"][l])
        assert want.dtype == np.float32
        assert np.array_equal(moe["router"].numpy(), want)
        assert np.array_equal(moe["w_up"].float().numpy(),
                              np.asarray(rparams["layers"]["moe"]["w_up"][l], np.float32))
