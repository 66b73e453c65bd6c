"""The port's vlm (M-RoPE over patch embeddings) and audio (frame
embeddings) families against the reference's, on the CPU.

`rope_angles` with sections against the reference's on three distinct
position streams. Reduced qwen2-vl-72b (sections (8, 4, 4) over 16 rotary
frequencies) with the reference's weights bridged: prefill of patch
embeddings drawn from a seed at Qwen2-VL's positions (arXiv:2409.12191
§2.1: a text prefix with t = h = w = i, then a grid of patches with t fixed
and h, w its row and column), then serve_step and extend_step, logits and
caches against the reference under both of the port's exec configs.
Reduced musicgen-medium: prefill of frame embeddings, serve_step fed frame
embeddings (`embeds=`), extend_step of tokens.

A control: with distinct streams, the port run with the sections permuted
must miss the reference. With three equal streams M-RoPE is plain RoPE, so
a wrong split would pass there (the test shows that it does).

Both families through the engine: standalone serialized on the gather
path, greedy streams and modelled clock equal to the reference engine's
(prompts of 5, 19 and 33 tokens, 6 new tokens). The paged blocks refuse
M-RoPE with the reference's words, and the engine's paged path refuses it.

Tolerances (max|a - b| / max|b|): 1e-4 in fp32 (summation order only).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_family_cases import TOL, assert_cache_close, bridged, port_run, ref_run, rel_err
from repro.models import backbone as rbb
from repro.models import layers as rlayers
from repro_torch.models import attention, backbone, layers
from repro_torch.models.layers import ExecConfig
from repro_torch.serving.engine import ServingEngine

EXECS = {"kernels": ExecConfig(), "blocked": ExecConfig(use_kernels=False)}
B, PREFIX, GRID = 2, 3, 4               # text prefix of 3, then a 4 x 4 patch grid
S = PREFIX + GRID * GRID


def vl_positions(b=B) -> np.ndarray:
    """(3, B, S) int32 streams (t, h, w) of a text prefix and a patch grid."""
    text = np.arange(PREFIX)
    row, col = np.divmod(np.arange(GRID * GRID), GRID)
    t = np.concatenate([text, np.full(GRID * GRID, PREFIX)])
    h = np.concatenate([text, PREFIX + row])
    w = np.concatenate([text, PREFIX + col])
    return np.broadcast_to(np.stack([t, h, w])[:, None, :], (3, b, S)).astype(np.int32).copy()


@pytest.mark.parametrize("head_dim,sections", [(32, (8, 4, 4)), (128, (16, 24, 24))])
def test_rope_angles_with_sections_match_reference(head_dim, sections):
    pos = np.random.default_rng(0).integers(0, 500, size=(3, 2, 7)).astype(np.int32)
    want = rlayers.rope_angles(jnp.asarray(pos), head_dim, 1e6, sections)
    got = layers.rope_angles(torch.from_numpy(pos), head_dim, 1e6, sections)
    for g, w in zip(got, want):
        assert g.shape == (2, 7, head_dim // 2)
        assert rel_err(g, w) < TOL["float32"]


def _embeds(cfg, n, seed):
    x = np.random.default_rng(seed).standard_normal((n, S, cfg.d_model)) * 0.5
    return x.astype(np.float32)


def _vl_prefill(cfg_port=None, positions=None, ex=ExecConfig()):
    rcfg, rparams, cfg, params = bridged("qwen2-vl-72b")
    emb = _embeds(cfg, B, 1)
    pos = vl_positions() if positions is None else positions
    want = rbb.prefill(rparams, {"embeds": jnp.asarray(emb), "positions": jnp.asarray(pos)},
                       rcfg)
    got = backbone.prefill(params, {"embeds": torch.from_numpy(emb),
                                    "positions": torch.from_numpy(pos)}, cfg_port or cfg, ex)
    return got, want




@pytest.mark.parametrize("exec_name", sorted(EXECS))
def test_vlm_prefill_serve_and_extend_match_reference(exec_name):
    ex = EXECS[exec_name]
    rcfg, rparams, cfg, params = bridged("qwen2-vl-72b")
    (gl, gc), (wl, wc) = _vl_prefill(ex=ex)
    assert rel_err(gl, wl) < TOL["float32"]
    assert_cache_close(gc, wc)
    wc = rbb._grow_cache(wc, rcfg, S + 8)
    gc = backbone._grow_cache(gc, cfg, S + 8)
    rng = np.random.default_rng(4)
    nxt = rng.integers(1, cfg.vocab_size, size=(B,)).astype(np.int32)
    wl, wc = rbb.serve_step(rparams, wc, nxt, rcfg)
    gl, gc = backbone.serve_step(params, gc, torch.from_numpy(nxt), cfg, ex)
    assert rel_err(gl, wl) < TOL["float32"]
    assert_cache_close(gc, wc)
    ext = rng.integers(1, cfg.vocab_size, size=(B, 3)).astype(np.int32)
    wl, wc = rbb.extend_step(rparams, wc, ext, rcfg)
    gl, gc = backbone.extend_step(params, gc, torch.from_numpy(ext), cfg, ex)
    assert gl.shape == (B, 3, cfg.vocab_size)
    assert rel_err(gl, wl) < TOL["float32"]
    assert_cache_close(gc, wc)


def test_permuted_sections_miss_the_reference():
    """The control: (4, 8, 4) in place of (8, 4, 4) misses on distinct
    streams, and passes on three equal ones, where M-RoPE is plain RoPE."""
    _, _, cfg, _ = bridged("qwen2-vl-72b")
    assert cfg.attn.m_rope_sections == (8, 4, 4)
    wrong = dataclasses.replace(cfg, attn=dataclasses.replace(cfg.attn,
                                                              m_rope_sections=(4, 8, 4)))
    (gl, _), (wl, _) = _vl_prefill(wrong)
    assert rel_err(gl, wl) > 100 * TOL["float32"]
    equal = np.broadcast_to(np.arange(S, dtype=np.int32), (3, B, S)).copy()
    (gl, _), (wl, _) = _vl_prefill(wrong, equal)
    assert rel_err(gl, wl) < TOL["float32"]


@pytest.mark.parametrize("exec_name", sorted(EXECS))
def test_audio_frames_match_reference(exec_name):
    ex = EXECS[exec_name]
    rcfg, rparams, cfg, params = bridged("musicgen-medium")
    emb = _embeds(cfg, B, 2)
    wl, wc = rbb.prefill(rparams, {"embeds": jnp.asarray(emb)}, rcfg)
    gl, gc = backbone.prefill(params, {"embeds": torch.from_numpy(emb)}, cfg, ex)
    assert rel_err(gl, wl) < TOL["float32"]
    assert_cache_close(gc, wc)
    wc = rbb._grow_cache(wc, rcfg, S + 8)
    gc = backbone._grow_cache(gc, cfg, S + 8)
    frame = np.random.default_rng(3).standard_normal((B, cfg.d_model)).astype(np.float32)
    nxt = np.zeros(B, np.int32)             # ignored beside the frame embeddings
    wl, wc = rbb.serve_step(rparams, wc, nxt, rcfg, embeds=jnp.asarray(frame))
    gl, gc = backbone.serve_step(params, gc, torch.from_numpy(nxt), cfg, ex,
                                 embeds=torch.from_numpy(frame))
    assert rel_err(gl, wl) < TOL["float32"]
    assert_cache_close(gc, wc)
    ext = np.random.default_rng(4).integers(1, cfg.vocab_size, size=(B, 3)).astype(np.int32)
    wl, wc = rbb.extend_step(rparams, wc, ext, rcfg)
    gl, gc = backbone.extend_step(params, gc, torch.from_numpy(ext), cfg, ex)
    assert rel_err(gl, wl) < TOL["float32"]
    assert_cache_close(gc, wc)


def test_paged_blocks_refuse_m_rope():
    _, _, cfg, _ = bridged("qwen2-vl-72b")
    with pytest.raises(ValueError, match="paged decode does not support m-rope"):
        attention.attention_paged_decode_block(None, None, None, None, None, None, None, cfg)
    with pytest.raises(ValueError, match="paged prefill does not support m-rope"):
        attention.attention_paged_chunk_block(None, None, None, None, None, 0, cfg)
    with pytest.raises(ValueError, match="'dense', 'moe'"):
        backbone.serve_step_paged(None, None, None, None, None, None, cfg)


@pytest.mark.parametrize("arch", ["qwen2-vl-72b", "musicgen-medium"])
def test_engine_serves_like_the_reference(arch):
    want, want_clock = ref_run(arch, "standalone", "serialized")
    got, eng = port_run(arch, "standalone", "serialized", "auto")
    assert eng.paged is False       # the engine pages the dense and moe families only
    assert got == want
    assert eng.clock == want_clock


def test_paged_engine_refuses_m_rope():
    _, _, cfg, params = bridged("qwen2-vl-72b")
    with pytest.raises(ValueError, match="paged attention unsupported"):
        ServingEngine(cfg, params, paged=True, device="cpu")
