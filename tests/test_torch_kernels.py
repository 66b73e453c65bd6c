"""The port's attention ops against the reference's, on the CPU.

For each of the four kernels on the serving path, the same inputs (numpy
draws from a seed) go through the reference's Pallas kernel in interpret
mode (as tests/test_kernels.py and tests/test_paged_kernels.py run it), the
reference's jnp oracle, and the port's op, which on CPU tensors takes the
kernel's plain PyTorch version; the port's own fp32 oracles are held to the
reference's too. The CUDA kernels themselves run only on the card
(tests/test_torch_cuda.py, chip_smoke.py).

Tolerances, as max|a - b| / max|b|: flash fp32 2e-4, bf16 5e-2 (the
reference's own); the decodes 1e-4 in fp32; the paged prefill, a flash-type
prefill, as flash.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro_torch.kernels import ops, ref
from repro_torch.serving.kv_cache import PagedKVPool
from repro_torch.configs import get_reduced_config

TOL_FLASH = {"float32": 2e-4, "bfloat16": 5e-2}
TOL_DECODE = 1e-4


def _rel_err(a, b):
    a = np.asarray(a.float() if isinstance(a, torch.Tensor) else a, np.float32)
    b = np.asarray(b.float() if isinstance(b, torch.Tensor) else b, np.float32)
    return np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-6)


class Draw:
    """Same numbers for both frameworks: numpy fp32, rounded to `dtype`."""

    def __init__(self, seed: int, dtype: str = "float32"):
        self.rng = np.random.default_rng(seed)
        self.dtype = dtype

    def __call__(self, *shape):
        x = self.rng.standard_normal(shape).astype(np.float32)
        return jnp.asarray(x, self.dtype), torch.from_numpy(x).to(getattr(torch, self.dtype))


def _ints(values):
    a = np.asarray(values, np.int32)
    return jnp.asarray(a), torch.from_numpy(a)


TR = lambda a: a.transpose(0, 2, 1, 3)  # noqa: E731


# ---------------------------------------------------------------- flash
@pytest.mark.parametrize("s,h,kv,d,block", [
    (64, 4, 4, 32, 32), (128, 4, 2, 32, 32), (64, 8, 1, 16, 32),
    (37, 4, 2, 32, 37), (33, 8, 1, 16, 33)])          # odd S
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_vs_reference(s, h, kv, d, block, dtype):
    draw = Draw(0, dtype)
    (qj, qt), (kj, kt), (vj, vt) = draw(2, s, h, d), draw(2, s, kv, d), draw(2, s, kv, d)
    got = ops.flash_attention(qt, kt, vt)
    pallas = rops.flash_attention(qj, kj, vj, block_q=block, block_k=block)
    oracle = TR(rref.flash_attention_ref(TR(qj), TR(kj), TR(vj)))
    mine = ref.flash_attention_ref(qt.transpose(1, 2), kt.transpose(1, 2),
                                   vt.transpose(1, 2)).transpose(1, 2)
    tol = TOL_FLASH[dtype]
    assert _rel_err(got, pallas) < tol
    assert _rel_err(got, oracle) < tol
    assert _rel_err(mine, oracle) < tol


# --------------------------------------------------------------- decode
@pytest.mark.parametrize("s,kv,g", [(64, 2, 2), (128, 1, 8), (32, 4, 1), (45, 2, 4)])
def test_decode_attention_vs_reference(s, kv, g):
    draw = Draw(1)
    b, d = 3, 32
    (qj, qt), (kj, kt), (vj, vt) = draw(b, 1, kv * g, d), draw(b, kv, s, d), draw(b, kv, s, d)
    pj, pt = _ints([0, s // 2, s - 1])
    got = ops.decode_attention(qt, kt, vt, pt)
    block = 16 if s % 16 == 0 else s
    pallas = rops.decode_attention(qj, kj, vj, pj, block_k=block)
    oracle = rref.decode_attention_ref(qj[:, 0].reshape(b, kv, g, d), kj, vj, pj)
    mine = ref.decode_attention_ref(qt[:, 0].reshape(b, kv, g, d), kt, vt, pt)
    assert _rel_err(got, pallas) < TOL_DECODE
    assert _rel_err(got, oracle.reshape(b, 1, kv * g, d)) < TOL_DECODE
    assert _rel_err(mine, oracle) < TOL_DECODE


def test_decode_attention_masks_future():
    """Cache contents past pos must not change the output at all."""
    draw = Draw(2)
    _, q = draw(1, 1, 4, 16)
    _, kc = draw(1, 2, 32, 16)
    _, vc = draw(1, 2, 32, 16)
    pos = torch.tensor([10], dtype=torch.int32)
    out1 = ops.decode_attention(q, kc, vc, pos)
    pk, pv = kc.clone(), vc.clone()
    pk[:, :, 11:] = 1e3
    pv[:, :, 11:] = -1e3
    assert torch.equal(ops.decode_attention(q, pk, pv, pos), out1)


# --------------------------------------------------------- paged decode
def _decode_case(draw, b, kvh, g, d, bs, nbp, nb, lengths):
    """Random pool pages + per-seq tables covering `lengths` tokens each."""
    kp, vp = draw(nbp, kvh, bs, d), draw(nbp, kvh, bs, d)
    perm = draw.rng.permutation(nbp - 1)      # keep the last page free as a dump
    tables = _ints(perm[: b * nb].reshape(b, nb))
    return (draw(b, 1, kvh * g, d), kp, vp, tables, _ints(lengths),
            draw(b, 1, kvh, d), draw(b, 1, kvh, d))


@pytest.mark.parametrize("kvh,g", [(2, 1), (2, 4), (1, 8)])
def test_paged_decode_vs_reference(kvh, g):
    draw = Draw(0)
    b, d, bs, nb = 3, 32, 8, 3
    lengths = [5, 17, 23]          # ragged: mid-block, block-aligned + 1, last slot
    q, kp, vp, tables, lens, kn, vn = _decode_case(draw, b, kvh, g, d, bs, 16, nb, lengths)
    args_j = [x[0] for x in (q, kp, vp, tables, lens, kn, vn)]
    args_t = [x[1] for x in (q, kp, vp, tables, lens, kn, vn)]
    got = ops.paged_decode_attention(*args_t, max_len=24)
    pallas = rops.paged_decode_attention(*args_j, max_len=24, impl="pallas")
    twin = rops.paged_decode_attention(*args_j, max_len=24, impl="jnp")
    qj, kpj, vpj, tj, lj, knj, vnj = args_j
    oracle = rref.paged_decode_attention_ref(
        qj.reshape(b, kvh, g, d), kpj, vpj, tj, lj, TR(knj), TR(vnj))
    qt, kpt, vpt, tt, lt, knt, vnt = args_t
    mine = ref.paged_decode_attention_ref(
        qt.reshape(b, kvh, g, d), kpt, vpt, tt, lt, knt.transpose(1, 2), vnt.transpose(1, 2))
    assert _rel_err(got, pallas) < TOL_DECODE
    assert _rel_err(got, twin) < TOL_DECODE
    assert _rel_err(got, oracle.reshape(b, 1, kvh * g, d)) < TOL_DECODE
    assert _rel_err(mine, oracle) < TOL_DECODE


def test_paged_decode_ragged_tail_and_dump_masked():
    """Finite poison in slots past `lengths` and in the dump page must be
    unobservable."""
    draw = Draw(1)
    b, kvh, g, d, bs, nb = 2, 2, 2, 32, 8, 2
    q, kp, vp, tables, lens, kn, vn = (x[1] for x in _decode_case(
        draw, b, kvh, g, d, bs, 12, nb, [3, 9]))
    base = ops.paged_decode_attention(q, kp, vp, tables, lens, kn, vn, max_len=10)
    pk, pv = kp.clone(), vp.clone()
    pk[tables[:, 1].long(), :, 2:] = 1e4    # seq 0 (len 3) never reads its 2nd page
    pv[tables[:, 1].long(), :, 2:] = -1e4
    pk[-1], pv[-1] = 1e4, -1e4                # the dump page
    out = ops.paged_decode_attention(q, pk, pv, tables, lens, kn, vn, max_len=10)
    assert torch.equal(out[0], base[0])
    assert torch.isfinite(out).all()


def test_paged_decode_shared_prefix_blocks():
    """Two sequences adopting the SAME physical blocks (refcount > 1) read
    identical context through their tables; freeing one leaves the other's
    pages intact."""
    cfg = get_reduced_config("yi-6b", num_layers=2, dtype="float32")
    pool = PagedKVPool(cfg, num_blocks=16, block_size=8, dtype=torch.float32)
    pool.allocate(0, 16)                      # donor: two full blocks
    draw = Draw(3)
    L, KV, D = pool.k.shape[0], pool.k.shape[2], pool.k.shape[4]
    _, kc = draw(L, KV, 16, D)
    pool.scatter_chunk(0, kc, kc, 0)
    shared = list(pool.seq(0).block_table)
    pool.adopt(1, shared, 16)
    pool.adopt(2, shared, 16)
    assert all(pool.block_refs(bid) == 3 for bid in shared)
    tables = pool.device_tables([1, 2], pool.blocks_needed(17))
    assert torch.equal(tables[0], tables[1])
    _, q1 = draw(1, 1, cfg.attn.num_heads, D)
    _, kn = draw(1, 1, KV, D)
    lens = torch.tensor([16, 16], dtype=torch.int32)
    two = ops.paged_decode_attention(torch.cat([q1, q1]), pool.k[0], pool.v[0], tables,
                                     lens, torch.cat([kn, kn]), torch.cat([kn, kn]),
                                     max_len=17)
    assert torch.equal(two[0], two[1])
    pool.free(1)
    assert all(pool.block_refs(bid) == 2 for bid in shared)
    after = ops.paged_decode_attention(q1, pool.k[0], pool.v[0], tables[1:], lens[1:],
                                       kn, kn, max_len=17)
    assert torch.equal(after[0], two[1])


# -------------------------------------------------------- paged prefill
@pytest.mark.parametrize("group,ctx,c", [(1, 13, 5), (4, 8, 8), (2, 0, 7), (1, 21, 9)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_prefill_vs_reference(group, ctx, c, dtype):
    draw = Draw(2, dtype)
    kvh, d, bs, nbp = 2, 32, 8, 10
    (kpj, kpt), (vpj, vpt) = draw(nbp, kvh, bs, d), draw(nbp, kvh, bs, d)
    nb = max((ctx + bs - 1) // bs, 1)
    tj, tt = _ints(draw.rng.permutation(nbp - 1)[:nb])
    (qj, qt) = draw(1, c, kvh * group, d)
    (ksj, kst), (vsj, vst) = draw(1, c, kvh, d), draw(1, c, kvh, d)
    got = ops.paged_prefill_attention(qt, kpt, vpt, tt, ctx, kst, vst)
    pallas = rops.paged_prefill_attention(qj, kpj, vpj, tj, ctx, ksj, vsj, impl="pallas")
    q_tm = qj[0].reshape(c, kvh, group, d).transpose(1, 0, 2, 3).reshape(kvh, c * group, d)
    oracle = rref.paged_prefill_attention_ref(
        q_tm, kpj, vpj, tj, jnp.int32(ctx), ksj[0].transpose(1, 0, 2),
        vsj[0].transpose(1, 0, 2), group=group)
    q_tt = qt[0].reshape(c, kvh, group, d).permute(1, 0, 2, 3).reshape(kvh, c * group, d)
    mine = ref.paged_prefill_attention_ref(q_tt, kpt, vpt, tt, ctx, kst[0].transpose(0, 1),
                                           vst[0].transpose(0, 1), group=group)
    oracle_bshd = np.asarray(oracle.astype(jnp.float32)).reshape(
        kvh, c, group, d).transpose(1, 0, 2, 3).reshape(1, c, kvh * group, d)
    tol = TOL_FLASH[dtype]
    assert _rel_err(got, pallas) < tol
    assert _rel_err(got, oracle_bshd) < tol
    assert _rel_err(mine, oracle) < tol


def test_impl_switch():
    """impl="torch" is the plain version on any device; anything else but
    "auto" is refused."""
    draw = Draw(4)
    (_, q), (_, k), (_, v) = draw(1, 8, 2, 32), draw(1, 8, 2, 32), draw(1, 8, 2, 32)
    assert torch.equal(ops.flash_attention(q, k, v, impl="torch"), ops.flash_attention(q, k, v))
    with pytest.raises(ValueError, match="impl"):
        ops.flash_attention(q, k, v, impl="pallas")
