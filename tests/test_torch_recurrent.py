"""The port's recurrent families (RWKV6 `ssm`, Zamba2 `hybrid`) against the
reference's, on the CPU.

Kernels: the same inputs (numpy draws from a seed, nonzero state0) go
through the reference's Pallas WKV/SSD kernels in interpret mode (through
`repro.kernels.ops`, as tests/test_kernels.py runs them), the reference's
per-token jnp oracles, the port's ops (which on CPU tensors take the kernels'
plain versions) and the port's own per-token oracles. Shapes are
tests/test_kernels.py's sweep plus a ragged T = 40.

Backbone: reduced rwkv6-7b and zamba2-2.7b with the reference's weights
bridged by `from_reference`. Prefill logits and every cache entry against
the reference's prefill under ExecConfig() (port: use_kernels=False, the
reference's chunked math) and ExecConfig(use_kernels=True) (port: the ops'
plain versions; reference: Pallas in interpret mode); 8 greedy serve_step
tokens identical to the reference's; an extend_step of 3 tokens.

Tolerances, as max|a - b| / max|b|: 1e-4 in fp32 (the two frameworks differ
in summation order only; the chunked and per-token forms in the order of
the recurrence); 5e-2 for the bf16 prefill logits (the frameworks round
the activations at different places through every layer, as
tests/test_torch_model.py's bf16 limit).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as ref_config
from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro.models import backbone as rbb
from repro.models.layers import ExecConfig as RefExec
from repro_torch.configs import get_reduced_config
from repro_torch.kernels import ops, ref
from repro_torch.models import backbone
from repro_torch.models.layers import ExecConfig
from repro_torch.weights import from_reference

TOL = {"float32": 1e-4, "bfloat16": 5e-2}
ARCHS = ["rwkv6-7b", "zamba2-2.7b"]
# exec mode -> (port's ExecConfig, reference's ExecConfig)
EXECS = {"blocked": (ExecConfig(use_kernels=False), RefExec()),
         "kernels": (ExecConfig(), RefExec(use_kernels=True))}
PROMPT = (2, 19)
STEPS, EXTEND = 8, 3

TR = lambda a: a.transpose(0, 2, 1, 3)  # noqa: E731
TT = lambda a: a.permute(0, 2, 1, 3)    # noqa: E731


def _rel_err(a, b):
    a = np.asarray(a.float() if isinstance(a, torch.Tensor) else a, np.float32)
    b = np.asarray(b.float() if isinstance(b, torch.Tensor) else b, np.float32)
    return np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-6)


def _both(x):
    """The same numpy fp32 values as a jax array and a torch tensor."""
    x = np.asarray(x, np.float32)
    return jnp.asarray(x), torch.from_numpy(x.copy())


# ---------------------------------------------------------------- kernels
@pytest.mark.parametrize("t,h,n,chunk", [(32, 2, 16, 16), (64, 3, 32, 16), (48, 1, 16, 8),
                                         (40, 2, 16, 16)])
def test_rwkv6_wkv_vs_reference(t, h, n, chunk):
    rng = np.random.default_rng(3)
    b = 2
    (rj, rt), (kj, kt), (vj, vt) = (_both(rng.standard_normal((b, t, h, n)) * 0.5)
                                    for _ in range(3))
    lw = np.clip(-np.exp(rng.standard_normal((b, t, h, n)) * 0.5), -8.0, -1e-4)
    (lj, lt), (uj, ut) = _both(lw), _both(rng.standard_normal((h, n)) * 0.1)
    sj, st = _both(rng.standard_normal((b, h, n, n)) * 0.1)
    got_y, got_s = ops.rwkv6_wkv(rt, kt, vt, lt, ut, st)
    pal_y, pal_s = rops.rwkv6_wkv(rj, kj, vj, lj, uj, sj, chunk=chunk)
    ora_y, ora_s = rref.rwkv6_wkv_ref(TR(rj), TR(kj), TR(vj), TR(lj), uj, sj)
    my_y, my_s = ref.rwkv6_wkv_ref(TT(rt), TT(kt), TT(vt), TT(lt), ut, st)
    tol = TOL["float32"]
    assert got_y.dtype == torch.float32 and got_y.shape == (b, t, h, n)
    assert _rel_err(got_y, pal_y) < tol and _rel_err(got_s, pal_s) < tol
    assert _rel_err(got_y, TR(ora_y)) < tol and _rel_err(got_s, ora_s) < tol
    assert _rel_err(my_y, ora_y) < tol and _rel_err(my_s, ora_s) < tol


@pytest.mark.parametrize("t,h,p,n,chunk", [(32, 2, 16, 8, 16), (64, 3, 32, 16, 32),
                                           (40, 2, 16, 16, 16)])
def test_mamba2_ssd_vs_reference(t, h, p, n, chunk):
    rng = np.random.default_rng(4)
    b = 2
    xj, xt = _both(rng.standard_normal((b, t, h, p)) * 0.5)
    (bj, bt), (cj, ct) = (_both(rng.standard_normal((b, t, n)) * 0.5) for _ in range(2))
    dj, dtt = _both(np.log1p(np.exp(rng.standard_normal((b, t, h)))))   # softplus
    aj, at = _both(np.log(np.linspace(1.0, 4.0, h)))
    sj, st = _both(rng.standard_normal((b, h, n, p)) * 0.1)
    got_y, got_s = ops.mamba2_ssd(xt, bt, ct, dtt, at, st)
    pal_y, pal_s = rops.mamba2_ssd(xj, bj, cj, dj, aj, sj, chunk=chunk)
    ora_y, ora_s = rref.mamba2_ssd_ref(TR(xj), bj, cj, dj.transpose(0, 2, 1), aj, sj)
    my_y, my_s = ref.mamba2_ssd_ref(TT(xt), bt, ct, dtt.transpose(1, 2), at, st)
    tol = TOL["float32"]
    assert got_y.dtype == torch.float32 and got_y.shape == (b, t, h, p)
    assert _rel_err(got_y, pal_y) < tol and _rel_err(got_s, pal_s) < tol
    assert _rel_err(got_y, TR(ora_y)) < tol and _rel_err(got_s, ora_s) < tol
    assert _rel_err(my_y, ora_y) < tol and _rel_err(my_s, ora_s) < tol


# --------------------------------------------------------------- backbone
def _bridged(arch, dtype):
    rcfg = ref_config(arch, dtype=dtype)
    cfg = get_reduced_config(arch, dtype=dtype)
    rparams = rbb.init_params(jax.random.PRNGKey(0), rcfg)
    params = from_reference(jax.tree.map(np.asarray, rparams), cfg, device="cpu")
    tokens = np.random.default_rng(5).integers(1, cfg.vocab_size, size=PROMPT).astype(np.int32)
    return cfg, rcfg, params, rparams, tokens


@pytest.fixture(scope="module", params=ARCHS)
def run(request):
    """Reference and port runs of one reduced fp32 model, computed once:
    prefill under both exec modes, then (default exec) 8 greedy serve_steps
    from the grown prefill cache and an extend_step of 3 tokens."""
    arch = request.param
    cfg, rcfg, params, rparams, tokens = _bridged(arch, "float32")
    max_seq = PROMPT[1] + STEPS + EXTEND
    out = {"arch": arch, "prefill": {}}
    for name, (ex, rex) in EXECS.items():
        want = rbb.prefill(rparams, {"tokens": tokens}, rcfg, rex)
        got = backbone.prefill(params, {"tokens": torch.from_numpy(tokens)}, cfg, ex)
        out["prefill"][name] = (got, want)

    step = jax.jit(rbb.serve_step, static_argnums=(3,))
    (wl, wc), (gl, gc) = out["prefill"]["blocked"][1], out["prefill"]["kernels"][0]
    wc = rbb._grow_cache(wc, rcfg, max_seq)
    gc = backbone._grow_cache(gc, cfg, max_seq)
    want_tok, got_tok, step_err = [], [], 0.0
    for _ in range(STEPS):
        wt, gt = jnp.argmax(wl, -1).astype(jnp.int32), gl.argmax(-1).to(torch.int32)
        want_tok.append(np.asarray(wt).tolist())
        got_tok.append(gt.tolist())
        wl, wc = step(rparams, wc, wt, rcfg)
        gl, gc = backbone.serve_step(params, gc, gt, cfg)
        step_err = max(step_err, _rel_err(gl, wl))
    out["greedy"] = (got_tok, want_tok, step_err, gc, wc)
    ext = np.random.default_rng(6).integers(1, cfg.vocab_size, (PROMPT[0], EXTEND)).astype(np.int32)
    # the port's extend_step writes K/V into the cache it is given: a copy
    gc_copy = {k: v.clone() for k, v in gc.items()}
    out["extend"] = (backbone.extend_step(params, gc_copy, torch.from_numpy(ext), cfg),
                     rbb.extend_step(rparams, wc, ext, rcfg))
    return out


def _cache_errs(got, want):
    assert sorted(got) == sorted(want)
    return {k: _rel_err(got[k], want[k]) for k in want if k != "pos"}


@pytest.mark.parametrize("exec_name", sorted(EXECS))
def test_prefill_matches_reference(run, exec_name):
    (gl, gc), (wl, wc) = run["prefill"][exec_name]
    tol = TOL["float32"]
    assert _rel_err(gl, wl) < tol
    errs = _cache_errs(gc, wc)
    assert max(errs.values()) < tol, errs
    assert gc["pos"].tolist() == np.asarray(wc["pos"]).tolist()


def test_greedy_serve_steps_match_reference(run):
    got_tok, want_tok, step_err, gc, wc = run["greedy"]
    assert got_tok == want_tok
    assert step_err < TOL["float32"]
    errs = _cache_errs(gc, wc)
    assert max(errs.values()) < TOL["float32"], errs
    assert gc["pos"].tolist() == np.asarray(wc["pos"]).tolist()


def test_extend_step_matches_reference(run):
    (gl, gc), (wl, wc) = run["extend"]
    assert gl.shape == (PROMPT[0], EXTEND, gl.shape[-1])
    assert _rel_err(gl, wl) < TOL["float32"]
    errs = _cache_errs(gc, wc)
    assert max(errs.values()) < TOL["float32"], errs
    assert gc["pos"].tolist() == np.asarray(wc["pos"]).tolist()


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_prefill_matches_reference(arch):
    cfg, rcfg, params, rparams, tokens = _bridged(arch, "bfloat16")
    wl, _ = rbb.prefill(rparams, {"tokens": tokens}, rcfg, RefExec(use_kernels=True))
    gl, gc = backbone.prefill(params, {"tokens": torch.from_numpy(tokens)}, cfg)
    assert gl.dtype == torch.bfloat16 and torch.isfinite(gl.float()).all()
    assert _rel_err(gl, wl) < TOL["bfloat16"]


def test_init_cache_and_seeded_init():
    for arch in ARCHS:
        cfg = get_reduced_config(arch, dtype="float32")
        rcache = rbb.init_cache(ref_config(arch, dtype="float32"), 2, 24)
        cache = backbone.init_cache(cfg, 2, 24, device="cpu")
        assert {k: tuple(v.shape) for k, v in cache.items()} == \
            {k: tuple(v.shape) for k, v in rcache.items()}
        a = backbone.init_params(torch.Generator().manual_seed(3), cfg)
        b = backbone.init_params(torch.Generator().manual_seed(3), cfg)
        assert torch.equal(a["tok"]["embed"], b["tok"]["embed"])
        assert ("shared_attn" in a) == (cfg.family == "hybrid")
        logits, c = backbone.prefill(a, {"tokens": torch.arange(5)[None]}, cfg)
        assert logits.shape == (1, cfg.vocab_size) and torch.isfinite(logits).all()
        assert c["pos"].tolist() == [5]


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_entry_points_stay_dense_only(arch):
    cfg = get_reduced_config(arch, dtype="float32")
    with pytest.raises(ValueError, match="dense"):
        backbone.serve_step_paged(None, None, None, None, None, None, cfg)
    with pytest.raises(ValueError, match="dense"):
        backbone.prefill_chunk_paged(None, None, None, None, 0, None, cfg)
