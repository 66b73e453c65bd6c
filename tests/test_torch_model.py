"""The port's dense backbone against the reference's, on the CPU.

The reference's weights (`backbone.init_params(PRNGKey)`) are bridged into
the port through numpy (`repro_torch.weights.from_reference`); the same
tokens go through both. Logits and caches of prefill, serve_step,
serve_step_paged, prefill_chunk_paged and extend_step are compared for
reduced yi-6b (GQA) and reduced llama-300m (tied embeddings), in fp32 to
TOL["float32"] and in bf16 to TOL["bfloat16"] (max|a - b| / max|b|). The
port runs both its default exec config (attention through kernels/ops.py,
plain versions on the CPU) and use_kernels=False (the reference's blocked
math).
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as ref_config
from repro.models import backbone as rbb
from repro.serving.kv_cache import PagedKVPool as RefPool
from repro_torch.configs import _ARCH_MODULES, get_reduced_config
from repro_torch.models import backbone
from repro_torch.models.layers import ExecConfig
from repro_torch.serving.kv_cache import PagedKVPool
from repro_torch.weights import from_reference

# fp32: the two frameworks differ in summation order only; bf16: they round
# the activations at different places through two layers
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
ARCHS = ["yi-6b", "llama-300m"]
EXECS = {"kernels": ExecConfig(), "blocked": ExecConfig(use_kernels=False)}


def _rel_err(a, b):
    a = np.asarray(a.float() if isinstance(a, torch.Tensor) else a, np.float32)
    b = np.asarray(b.float() if isinstance(b, torch.Tensor) else b, np.float32)
    return np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-6)


@pytest.fixture(scope="module", params=[(a, dt) for a in ARCHS for dt in TOL],
                ids=lambda p: f"{p[0]}-{p[1]}")
def model(request):
    arch, dtype = request.param
    rcfg = ref_config(arch, num_layers=2, dtype=dtype)
    cfg = get_reduced_config(arch, num_layers=2, dtype=dtype)
    rparams = rbb.init_params(jax.random.PRNGKey(0), rcfg)
    params = from_reference(jax.tree.map(np.asarray, rparams), cfg, device="cpu")
    rng = np.random.default_rng(5)
    tokens = rng.integers(1, cfg.vocab_size, size=(2, 19)).astype(np.int32)
    return dict(cfg=cfg, rcfg=rcfg, params=params, rparams=rparams,
                tokens=tokens, tol=TOL[dtype], rng=rng)


def _prefill_both(m, tokens, ex):
    want_l, want_c = rbb.prefill(m["rparams"], {"tokens": tokens}, m["rcfg"])
    got_l, got_c = backbone.prefill(m["params"], {"tokens": torch.from_numpy(tokens)},
                                    m["cfg"], ex)
    return (got_l, got_c), (want_l, want_c)


@pytest.mark.parametrize("exec_name", sorted(EXECS))
def test_prefill_matches_reference(model, exec_name):
    (gl, gc), (wl, wc) = _prefill_both(model, model["tokens"], EXECS[exec_name])
    tol = model["tol"]
    assert _rel_err(gl, wl) < tol
    assert _rel_err(gc["k"], wc["k"]) < tol and _rel_err(gc["v"], wc["v"]) < tol
    assert gc["pos"].tolist() == np.asarray(wc["pos"]).tolist()


@pytest.mark.parametrize("exec_name", sorted(EXECS))
def test_serve_and_extend_steps_match_reference(model, exec_name):
    ex, tol = EXECS[exec_name], model["tol"]
    (_, gc), (_, wc) = _prefill_both(model, model["tokens"], ex)
    pad = 8
    wc = rbb._grow_cache(wc, model["rcfg"], model["tokens"].shape[1] + pad)
    gc = {"k": torch.nn.functional.pad(gc["k"], (0, 0, 0, pad)),
          "v": torch.nn.functional.pad(gc["v"], (0, 0, 0, pad)), "pos": gc["pos"]}
    nxt = model["rng"].integers(1, model["cfg"].vocab_size, size=(2,)).astype(np.int32)
    wl, wc2 = rbb.serve_step(model["rparams"], wc, nxt, model["rcfg"])
    gl, gc2 = backbone.serve_step(model["params"], gc, torch.from_numpy(nxt), model["cfg"], ex)
    assert _rel_err(gl, wl) < tol
    assert _rel_err(gc2["k"], wc2["k"]) < tol and _rel_err(gc2["v"], wc2["v"]) < tol
    assert gc2["pos"].tolist() == np.asarray(wc2["pos"]).tolist()
    ext = model["rng"].integers(1, model["cfg"].vocab_size, size=(2, 3)).astype(np.int32)
    wl, wc3 = rbb.extend_step(model["rparams"], wc2, ext, model["rcfg"])
    gl, gc3 = backbone.extend_step(model["params"], gc2, torch.from_numpy(ext), model["cfg"], ex)
    assert gl.shape == (2, 3, model["cfg"].vocab_size)
    assert _rel_err(gl, wl) < tol
    assert _rel_err(gc3["k"], wc3["k"]) < tol and _rel_err(gc3["v"], wc3["v"]) < tol
    assert gc3["pos"].tolist() == np.asarray(wc3["pos"]).tolist()


def _pools(model, lengths):
    """Reference and port pools holding the same prefill KV for ragged
    sequences (sequence i keeps the first lengths[i] tokens)."""
    (_, gc), (_, wc) = _prefill_both(model, model["tokens"], ExecConfig())
    rpool = RefPool(model["rcfg"], 16, 8, dtype=jax.numpy.dtype(model["rcfg"].dtype))
    pool = PagedKVPool(model["cfg"], 16, 8, dtype=gc["k"].dtype)
    for sid, n in enumerate(lengths):
        rpool.allocate(sid, n)
        rpool.scatter([sid], wc["k"][:, sid:sid + 1, :, :n], wc["v"][:, sid:sid + 1, :, :n])
        pool.allocate(sid, n)
        pool.scatter([sid], gc["k"][:, sid:sid + 1, :, :n], gc["v"][:, sid:sid + 1, :, :n])
    return rpool, pool


def test_serve_step_paged_matches_reference(model):
    tol, lengths = model["tol"], [19, 14]
    rpool, pool = _pools(model, lengths)
    max_len = max(lengths) + 1
    nb = pool.blocks_needed(max_len)
    nxt = model["rng"].integers(1, model["cfg"].vocab_size, size=(2,)).astype(np.int32)
    wl, wk, wv = rbb.serve_step_paged(
        model["rparams"], rpool.k, rpool.v, rpool.device_tables([0, 1], nb),
        jax.numpy.asarray(lengths, jax.numpy.int32), nxt, model["rcfg"], max_len=max_len,
        impl="jnp")
    gl, gk, gv = backbone.serve_step_paged(
        model["params"], pool.k, pool.v, pool.device_tables([0, 1], nb),
        torch.tensor(lengths, dtype=torch.int32), torch.from_numpy(nxt), model["cfg"],
        max_len=max_len)
    assert _rel_err(gl, wl) < tol
    assert _rel_err(gk, wk) < tol and _rel_err(gv, wv) < tol


@pytest.mark.parametrize("ctx0", [0, 11])
def test_prefill_chunk_paged_matches_reference(model, ctx0):
    tol = model["tol"]
    rpool, pool = _pools(model, [max(ctx0, 1), 1])
    chunk = model["tokens"][0, ctx0:ctx0 + 7]
    table_len = max(pool.blocks_needed(ctx0), 1)
    wl, wk, wv = rbb.prefill_chunk_paged(
        model["rparams"], rpool.k, rpool.v, rpool.device_tables([0], table_len)[0], ctx0,
        chunk, model["rcfg"], impl="jnp")
    gl, gk, gv = backbone.prefill_chunk_paged(
        model["params"], pool.k, pool.v, pool.device_tables([0], table_len)[0], ctx0,
        torch.from_numpy(chunk), model["cfg"])
    assert _rel_err(gl, wl) < tol
    assert _rel_err(gk, wk) < tol and _rel_err(gv, wv) < tol


@pytest.mark.parametrize("arch", sorted(_ARCH_MODULES))
def test_every_registry_arch_prefills(arch):
    """Every architecture of the registry, all six families, inits from a
    seeded generator on the CPU (reduced) and prefills to finite logits."""
    cfg = get_reduced_config(arch)
    params = backbone.init_params(torch.Generator().manual_seed(0), cfg)
    logits, cache = backbone.prefill(params, {"tokens": torch.arange(1, 6)[None]}, cfg)
    assert logits.shape == (1, cfg.vocab_size) and torch.isfinite(logits.float()).all()
    assert cache["pos"].tolist() == [5]


def test_init_params_is_seeded():
    cfg = get_reduced_config("llama-300m", num_layers=1, dtype="float32")
    a = backbone.init_params(torch.Generator().manual_seed(3), cfg)
    b = backbone.init_params(torch.Generator().manual_seed(3), cfg)
    assert torch.equal(a["layers"][0]["attn"]["wq"], b["layers"][0]["attn"]["wq"])
    assert "lm_head" not in a["tok"]          # tied embeddings
    logits, cache = backbone.prefill(a, {"tokens": torch.arange(5)[None]}, cfg)
    assert logits.shape == (1, cfg.vocab_size) and torch.isfinite(logits).all()
    assert cache["k"].shape == (1, 1, cfg.attn.num_kv_heads, 5, cfg.attn.head_dim)
