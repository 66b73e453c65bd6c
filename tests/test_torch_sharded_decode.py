"""The distributed decode and the per-shard regions of
distributed/tensor_parallel.py on a (data 2, model 2) gloo mesh, held to the
plain code on the same inputs (4 CPU processes, tests/_torch_dist.py, fp32).

- serve_step over params placed by `shard_params` and a cache placed by
  `cache_pspecs`, against serve_step on the plain tensors, for reduced
  yi-6b (K/V cache: its sequence sharded on "model", or on both mesh dims
  where the batch does not split over "data"; `write_slots` and
  `local_decode_attention`), rwkv6-7b (the WKV decode step on each rank's
  batch and head shards, `per_head_region`) and zamba2-2.7b (both): four
  steps from per-sequence positions that cross the shards' boundaries,
  logits each step and the whole cache after.
- The regions at shapes the reduced models do not give: write_slots of
  several tokens and local_decode_attention on caches sequence-sharded
  over one or both mesh dims, against `_write_at` and
  `decode_attention_plain`; attention whose one kv head does not split over
  "model" (the sequences split instead, or nothing); the chunked WKV and SSD
  and the WKV step with 3 heads, which do not split over "model", gradients
  included.

TOL: max |sharded - plain| / max |plain|. The two sum the same products in
other orders (a split softmax's max and sum over the shards, a
head-sharded projection's partial sums), which moves fp32 results by a few
ulps of the largest; 1e-5 is the port's fp32 limit for summation order
(tests/_torch_parity.py).
"""
import pytest

from _torch_dist import run_ranks

TOL = 1e-5

_SERVE = """
import sys
import torch, torch.distributed as dist
torch.set_num_threads(1)
dist.init_process_group("gloo")
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import get_reduced_config
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import backbone
from repro_torch.models.layers import TRAIN_EXEC
from repro_torch.training import train_step as ts
arch = sys.argv[1]
cfg = get_reduced_config(arch, dtype="float32")
params = backbone.init_params(torch.Generator().manual_seed(0), cfg)
mesh = make_host_mesh(2, 2)
sp = ts.shard_params(params, mesh)
worst = 0.0
# (batch, cache slots, positions): the sequence splits 16 + 16 over "model"
# (batch 4 over "data"), or 8 x 4 over both dims (batch 3)
for b, smax, pos in ((4, 32, [9, 13, 15, 16]), (3, 32, [5, 7, 22])):
    g = torch.Generator().manual_seed(b)
    cache = backbone.init_cache(cfg, b, smax, device="cpu")
    for k, v in cache.items():
        if k != "pos":
            v.copy_(0.5 * torch.randn(v.shape, generator=g))
    cache["pos"] = torch.tensor(pos, dtype=torch.int32)
    specs = sharding.cache_pspecs(cache, cfg, mesh)
    placed = {k: sharding.distribute(v, mesh, specs[k]) for k, v in cache.items()}
    if "k" in placed:
        assert any(p.is_shard(3) for p in placed["k"].placements), placed["k"].placements
    plain = {k: v.clone() for k, v in cache.items()}
    for step in range(4):
        tok = torch.randint(0, cfg.vocab_size, (b,), generator=g)
        with torch.no_grad():
            want, plain = backbone.serve_step(params, plain, tok, cfg, TRAIN_EXEC)
            with implicit_replication():
                got, placed = backbone.serve_step(
                    sp, placed, sharding.distribute(tok, mesh, sharding.tokens_pspec(
                        tok.shape, mesh)), cfg, TRAIN_EXEC)
        worst = max(worst, float((got.full_tensor() - want).abs().max() / want.abs().max()))
    for k, v in plain.items():
        full = placed[k].full_tensor() if hasattr(placed[k], "full_tensor") else placed[k]
        if k == "pos":
            assert torch.equal(full, v), (full, v)
        else:
            worst = max(worst, float((full - v).abs().max() / v.abs().max()))
print("ERR", worst, flush=True)
dist.destroy_process_group()
"""

_REGIONS = """
import torch, torch.distributed as dist
torch.set_num_threads(1)
dist.init_process_group("gloo")
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.kernels.decode_attention import NEG_INF, decode_attention_plain
from repro_torch.distributed.tensor_parallel import local_decode_attention, write_slots
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import attention, mamba2, rwkv6
mesh = make_host_mesh(2, 2)
g = torch.Generator().manual_seed(0)
worst = 0.0


def err(got, want):
    global worst
    got = got.full_tensor() if hasattr(got, "full_tensor") else got
    worst = max(worst, float((got - want).abs().max() / want.abs().max()))


def place(t, pl, grad=False):
    d = distribute_tensor(t.detach(), mesh, pl, src_data_rank=None)
    return d.requires_grad_() if grad else d


def with_grads(fn, args, placements, grad_of):
    # fn on plain tensors and on DTensors so placed, values and the
    # gradients of a fixed random projection of every output
    leaves = [a.detach().clone().requires_grad_(i in grad_of) if torch.is_tensor(a) else a
              for i, a in enumerate(args)]
    want = fn(*leaves)
    want = want if isinstance(want, tuple) else (want,)
    ws = [torch.randn(w.shape, generator=g) for w in want]
    sum((w * c).sum() for w, c in zip(want, ws)).backward()
    dargs = [place(a, pl, i in grad_of) if torch.is_tensor(a) else a
             for i, (a, pl) in enumerate(zip(args, placements))]
    got = fn(*dargs)
    got = got if isinstance(got, tuple) else (got,)
    sum((o.full_tensor() * c).sum() for o, c in zip(got, ws)).backward()
    for o, w in zip(got, want):
        err(o, w.detach())
    for i in grad_of:
        err(dargs[i].grad, leaves[i].grad)
    return got


# a cache (B, KV, S, D) sequence-sharded on "model" (batch on "data"), or on
# both mesh dims, or on "model" alone: write 3 tokens at positions that
# cross the shards' edges, then attend one token
for pl in ([Shard(0), Shard(2)], [Shard(2), Shard(2)], [Replicate(), Shard(2)]):
    b, kv, s, d, h = 4, 2, 32, 16, 4
    kc, vc = (torch.randn(b, kv, s, d, generator=g) for _ in range(2))
    new_k, new_v = (torch.randn(b, kv, 3, d, generator=g) for _ in range(2))
    pos = torch.tensor([6, 7, 15, 22], dtype=torch.int32)
    q = torch.randn(b, 1, h, d, generator=g)
    dk, dv = place(kc, pl), place(vc, pl)
    write_slots(dk, new_k, pos)
    write_slots(dv, new_v, pos)
    attention._write_at(kc, new_k, pos)
    attention._write_at(vc, new_v, pos)
    err(dk, kc)
    err(dv, vc)
    last = pos + 2
    err(local_decode_attention(q, dk, dv, last, NEG_INF), decode_attention_plain(q, kc, vc, last))

# one kv head against "model" = 2: batch 4 splits over both dims, batch 2
# (already split over "data") stays whole on "model"
for b, want_pl in ((4, ["S(0)", "S(0)"]), (2, ["S(0)", "R"])):
    q, k, v = (torch.randn(b, 16, hh, 8, generator=g) for hh in (4, 1, 1))
    pls = ([Shard(0), Shard(2)], [Shard(0), Replicate()], [Shard(0), Replicate()])
    out = with_grads(lambda q, k, v: attention.blocked_attention(q, k, v, True, 8),
                     (q, k, v), pls, (0, 1, 2))
    assert [str(p) for p in out[0].placements] == want_pl, out[0].placements

# 3 heads do not split over "model": each rank runs its batch shard whole
bt, t, hh, n = 4, 32, 3, 8
r, k, v = (torch.randn(bt, t, hh, n, generator=g) for _ in range(3))
logw = -torch.rand(bt, t, hh, n, generator=g) - 0.1
u = torch.randn(hh, n, generator=g)
s0 = torch.randn(bt, hh, n, n, generator=g)
bh = [Shard(0), Shard(2)]
with_grads(lambda *a: rwkv6.wkv_chunked(*a, chunk=16), (r, k, v, logw, u, s0),
           (bh, bh, bh, bh, [Replicate()] * 2, [Shard(0), Replicate()]), range(6))
with torch.no_grad():
    got = rwkv6.wkv_step(*(place(x[:, 0], [Shard(0), Replicate()]) for x in (r, k, v, logw)),
                         place(u, [Replicate()] * 2), place(s0, [Shard(0), Replicate()]))
    want = rwkv6.wkv_step(r[:, 0], k[:, 0], v[:, 0], logw[:, 0], u, s0)
    for a, w in zip(got, want):
        err(a, w)
p, nn = 8, 8
xh = torch.randn(bt, t, hh, p, generator=g)
bi, ci = (torch.randn(bt, t, nn, generator=g) for _ in range(2))
dt = torch.rand(bt, t, hh, generator=g) * 0.5
a_log = torch.randn(hh, generator=g) * 0.3
st = torch.randn(bt, hh, nn, p, generator=g)
bn = [Shard(0), Replicate()]
with_grads(lambda *a: mamba2.ssd_chunked(*a, chunk=16), (xh, bi, ci, dt, a_log, st),
           (bh, bn, bn, bh, [Replicate()] * 2, bn), range(6))
print("ERR", worst, flush=True)
dist.destroy_process_group()
"""


@pytest.mark.parametrize("arch", ["yi-6b", "rwkv6-7b", "zamba2-2.7b"])
def test_sharded_serve_step_equals_the_plain_one(arch):
    for out in run_ranks(_SERVE, 4, arch, timeout=240):
        f = out.split()
        assert float(f[f.index("ERR") + 1]) < TOL, out


def test_per_shard_regions_equal_the_plain_code():
    for out in run_ranks(_REGIONS, 4, timeout=240):
        f = out.split()
        assert float(f[f.index("ERR") + 1]) < TOL, out
