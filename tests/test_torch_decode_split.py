"""The decode kernels' split of the keys, on the CPU.

Both decode kernels (csrc/decode_core.cuh) split each sequence's keys
across blocks and merge the blocks' partial softmax states in a fixed order.
The split comes from `decode_splits`, a plain function of host-known shapes;
these tests hold it to its contract (every key in exactly one split, the
block target reached where the keys allow), and hold a test-local model of
split-then-merge, in the kernels' order of sums, to the plain versions and
to the reference's Pallas kernels in interpret mode, in fp32. The CUDA
kernels themselves run only on the card (tests/test_torch_cuda.py).

Tolerance: max|a - b| / max|b| < 1e-5, fp32 (the model and the plain
versions differ in summation order only).
"""
import itertools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import paged_attention as pag

TOL = 1e-5
NEG_INF = np.float32(-1e30)
H100_SMS = 132

# b, kv, groups, max_keys, sm_count: the path's shapes (llama-7b B 4 and
# B 1, the llama-1b draft, zamba2), then a seeded grid of others
PATH_SHAPES = [(4, 32, 1, 464, H100_SMS), (1, 32, 1, 464, H100_SMS),
               (4, 16, 1, 469, H100_SMS), (1, 16, 1, 464, H100_SMS),
               (4, 32, 1, 471, H100_SMS)]
_rng = np.random.default_rng(14)
GRID = [tuple(int(x) for x in (_rng.integers(1, 9), 2 ** _rng.integers(0, 7),
                               _rng.integers(1, 5), _rng.integers(1, 5000),
                               _rng.choice([1, 16, 78, 132])))
        for _ in range(24)]


@pytest.mark.parametrize("b,kv,groups,max_keys,sms", PATH_SHAPES + GRID)
def test_splits_cover_every_key_exactly_once(b, kv, groups, max_keys, sms):
    n, chunk = dec.decode_splits(b, kv, groups, max_keys, sms)
    assert n >= 1 and chunk % dec.KEY_TILE == 0
    assert n * chunk >= max_keys and (n - 1) * chunk < max_keys
    for length in sorted({0, 1, max_keys // 3, max_keys - 1, max_keys}):
        seen = np.zeros(max_keys, np.int64)
        for i in range(n):
            k0, k1 = i * chunk, min((i + 1) * chunk, length)
            seen[k0:max(k1, k0)] += 1
        assert (seen[:length] == 1).all() and (seen[length:] == 0).all()


@pytest.mark.parametrize("b,kv,groups,max_keys,sms", PATH_SHAPES + GRID[:8])
def test_splits_reach_the_block_target(b, kv, groups, max_keys, sms):
    """A function of its arguments only (no device is read: this runs on a
    machine without one), never above the target of BLOCKS_PER_SM blocks on
    each SM unless one split already is, and more than half the target's
    splits wherever the keys have that many tiles."""
    n, chunk = dec.decode_splits(b, kv, groups, max_keys, sms)
    assert (n, chunk) == dec.decode_splits(b, kv, groups, max_keys, sms)
    pairs, target = b * kv * groups, dec.BLOCKS_PER_SM * sms
    tiles = -(-max_keys // dec.KEY_TILE)
    want = max(target // pairs, 1)
    assert pairs * n <= max(target, pairs)
    assert n == tiles or 2 * n > want


def test_splits_at_the_path_shapes():
    """llama-7b serialized (one sequence, 32 kv heads, 459 keys): 4 splits
    of two 64-key tiles, 128 blocks; four sequences: one split; the
    llama-1b draft (16 kv heads): 8 splits at one sequence, 2 at four."""
    assert dec.decode_splits(1, 32, 1, 464, H100_SMS) == (4, 128)
    assert dec.decode_splits(4, 32, 1, 464, H100_SMS) == (1, 512)
    assert dec.decode_splits(1, 16, 1, 464, H100_SMS) == (8, 64)
    assert dec.decode_splits(4, 16, 1, 469, H100_SMS) == (2, 256)
    assert dec.decode_splits(64, 32, 1, 464, H100_SMS) == (1, 512)


@pytest.mark.parametrize("g,rows,groups", [(1, 1, 1), (2, 2, 1), (3, 4, 1), (4, 4, 1),
                                           (8, 8, 1), (12, 8, 2), (16, 8, 2)])
def test_rows_per_block(g, rows, groups):
    assert dec.rows_per_block(g) == rows and dec.row_groups(g) == groups


# ------------------------------------------------ the split-then-merge model
def _geometry(dtype: str, d: int, g: int):
    """The core's key processors and batch for (type, head dim, G), as
    decode_core.cuh's Geo computes them."""
    vec = 16 // (2 if dtype == "bfloat16" else 4)
    lanes = next(x for x in (4, 8, 16, 32) if d // vec <= x)
    nkp = 8 * (32 // lanes)                          # eight warps a block
    kpt = 64 // nkp
    rows = dec.rows_per_block(g)
    return nkp, min(kpt, max(8 // rows, 1))


def _fold(state, s, v, ok):
    """One batch of keys into a key processor's state (m, l, acc) of one
    row, as the core does: one max and one rescale a batch, fp32."""
    m, l, acc = state
    s = np.where(ok, s, NEG_INF).astype(np.float32)
    mx = np.float32(max(m, s.max()))
    alpha = np.exp(np.float32(m - mx))
    p = np.where(ok, np.exp(s - mx), np.float32(0)).astype(np.float32)
    return mx, np.float32(l * alpha + p.sum(dtype=np.float32)), (acc * alpha + p @ v).astype(np.float32)


def _merge(states, own=None):
    """States in order, then the own token (score, value row) if given."""
    m = max([s[0] for s in states] + ([own[0]] if own else [NEG_INF]))
    m = np.float32(m)
    l, a = np.float32(0), np.zeros_like(states[0][2])
    for sm, sl, sa in states:
        c = np.exp(np.float32(sm - m))
        l, a = np.float32(l + sl * c), (a + sa * c).astype(np.float32)
    if own:
        p = np.exp(np.float32(own[0] - m))
        l, a = np.float32(l + p), (a + p * own[1]).astype(np.float32)
    return m, l, a


def model_decode(q, keys, values, length, n, chunk, nkp, kb, own=None):
    """One query row q (D,) over keys/values (>= length, D) of one
    (sequence, kv head), fp32: split i of n folds [i * chunk, min((i + 1) *
    chunk, length)) in 64-key tiles, key processor p taking keys
    p + nkp * j of a tile in batches of kb; processors merge in order, then
    splits in order, then the own token (k, v) -> (D,)."""
    d = q.shape[0]
    c = np.float32(1 / math.sqrt(d))
    empty = (NEG_INF, np.float32(0), np.zeros(d, np.float32))
    partials = []
    for i in range(n):
        k0, k1 = i * chunk, min((i + 1) * chunk, length)
        procs = [empty] * nkp
        for t0 in range(k0, k1, 64):
            for p in range(nkp):
                for b0 in range(0, 64 // nkp, kb):
                    idx = [t0 + p + nkp * (b0 + u) for u in range(kb)]
                    ok = np.array([t < k1 for t in idx])
                    rows = [min(t, len(keys) - 1) for t in idx]
                    s = (keys[rows] @ q) * c
                    v = np.where(ok[:, None], values[rows], 0).astype(np.float32)
                    procs[p] = _fold(procs[p], s, v, ok)
        partials.append(_merge(procs))
    if own is not None:
        own = (np.float32((own[0] @ q) * c), own[1])
    m, l, a = _merge(partials, own) if n > 1 or own is not None else partials[0]
    return a / max(l, np.float32(1e-30))


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-6)


DENSE = [  # b, kv, g, s, d, pos, sms: splits of one tile and of several,
           # a split past a short sequence's end (empty), one split
    (2, 2, 1, 200, 32, [199, 3], 2), (1, 2, 4, 130, 32, [129], 132),
    (3, 1, 2, 300, 64, [0, 64, 299], 1), (2, 2, 8, 70, 16 * 2, [69, 63], 132)]


@pytest.mark.parametrize("b,kv,g,s,d,pos,sms", DENSE)
def test_split_merge_model_matches_dense_decode(b, kv, g, s, d, pos, sms):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((b, 1, kv * g, d)).astype(np.float32)
    kc, vc = (rng.standard_normal((b, kv, s, d)).astype(np.float32) for _ in range(2))
    n, chunk = dec.decode_splits(b, kv, dec.row_groups(g), s, sms)
    nkp, kb = _geometry("float32", d, g)
    got = np.zeros_like(q)
    for bi, h in itertools.product(range(b), range(kv * g)):
        got[bi, 0, h] = model_decode(q[bi, 0, h], kc[bi, h // g], vc[bi, h // g],
                                     min(pos[bi] + 1, s), n, chunk, nkp, kb)
    pt = torch.tensor(pos, dtype=torch.int32)
    plain = dec.decode_attention_plain(torch.from_numpy(q), torch.from_numpy(kc),
                                       torch.from_numpy(vc), pt)
    assert _rel(got, plain) < TOL
    pallas = rops.decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                   jnp.asarray(pos, jnp.int32), block_k=s if s % 16 else 16)
    assert _rel(got, pallas) < TOL


PAGED = [  # b, kv, g, d, bs, lengths, sms: length 0, ragged, a page
           # boundary, the own token merged last
    (3, 2, 1, 32, 8, [0, 17, 130], 132), (2, 1, 4, 64, 16, [64, 5], 2),
    (2, 2, 2, 32, 8, [129, 0], 1)]


@pytest.mark.parametrize("b,kv,g,d,bs,lengths,sms", PAGED)
def test_split_merge_model_matches_paged_decode(b, kv, g, d, bs, lengths, sms):
    rng = np.random.default_rng(4)
    nb = -(-(max(lengths) + 1) // bs)
    nbp = b * nb + 1
    kp, vp = (rng.standard_normal((nbp, kv, bs, d)).astype(np.float32) for _ in range(2))
    kp[-1], vp[-1] = 1e4, -1e4                          # the dump page
    tables = rng.permutation(nbp - 1)[: b * nb].reshape(b, nb).astype(np.int32)
    for bi, n_ in enumerate(lengths):                    # dump-padded past the length
        tables[bi, -(-n_ // bs):] = nbp - 1
    q = rng.standard_normal((b, 1, kv * g, d)).astype(np.float32)
    kn, vn = (rng.standard_normal((b, 1, kv, d)).astype(np.float32) for _ in range(2))
    n, chunk = dec.decode_splits(b, kv, dec.row_groups(g), nb * bs, sms)
    nkp, kb = _geometry("float32", d, g)
    got = np.zeros_like(q)
    for bi, h in itertools.product(range(b), range(kv * g)):
        kh = h // g
        keys = kp[tables[bi], kh].reshape(nb * bs, d)
        vals = vp[tables[bi], kh].reshape(nb * bs, d)
        got[bi, 0, h] = model_decode(q[bi, 0, h], keys, vals, lengths[bi], n, chunk, nkp, kb,
                                     own=(kn[bi, 0, kh], vn[bi, 0, kh]))
    max_len = max(lengths) + 1
    args = [torch.from_numpy(x) for x in (q, kp, vp, tables, np.asarray(lengths, np.int32),
                                          kn, vn)]
    plain = pag.paged_decode_attention_plain(*args, max_len)
    assert _rel(got, plain) < TOL
    pallas = rops.paged_decode_attention(
        *(jnp.asarray(x) for x in (q, kp, vp, tables, np.asarray(lengths, np.int32), kn, vn)),
        max_len=max_len, impl="pallas")
    assert _rel(got, pallas) < TOL
