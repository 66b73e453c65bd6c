"""The hand-written CUDA kernels on the card (marker `cuda`).

A CUDA kernel has no CPU mode, so these tests skip without a card; on the
machine with one run them with

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain version (impl="torch") on the same
CUDA tensors, its wrapper must refuse what the kernel does not take, and the
model's use_kernels=False path must refuse CUDA tensors. This file imports
neither JAX nor the reference package: the card's machine has neither.
"""
import pytest
import torch

from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import flash_attention as fla
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pag

pytestmark = pytest.mark.cuda

# max|kernel - plain| / max|plain|: fp32 differs in summation order only;
# bf16 plain versions round scores and probabilities to bf16
TOL = {torch.float32: 2e-4, torch.bfloat16: 5e-2}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


def _rand(gen, *shape, dtype=torch.float32):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _close(a, b, dtype):
    torch.cuda.synchronize()
    err = (a.float() - b.float()).abs().max() / (b.float().abs().max() + 1e-6)
    assert err < TOL[dtype], float(err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,h,kv,d", [(77, 8, 8, 128), (33, 8, 2, 64), (130, 16, 2, 32)])
def test_flash_kernel_matches_plain(gen, s, h, kv, d, dtype):
    q, k, v = _rand(gen, 2, s, h, d, dtype=dtype), _rand(gen, 2, s, kv, d, dtype=dtype), \
        _rand(gen, 2, s, kv, d, dtype=dtype)
    before = fla.KERNEL.launches
    _close(ops.flash_attention(q, k, v), ops.flash_attention(q, k, v, impl="torch"), dtype)
    assert fla.KERNEL.launches == before + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv,g,d", [(4, 1, 128), (2, 4, 64), (2, 8, 128), (1, 12, 32)])
def test_decode_kernels_match_plain(gen, kv, g, d, dtype):
    b, s, bs, nb = 3, 70, 16, 5
    pos = torch.tensor([0, 37, 69], dtype=torch.int32, device="cuda")
    q = _rand(gen, b, 1, kv * g, d, dtype=dtype)
    kc, vc = _rand(gen, b, kv, s, d, dtype=dtype), _rand(gen, b, kv, s, d, dtype=dtype)
    _close(ops.decode_attention(q, kc, vc, pos),
           ops.decode_attention(q, kc, vc, pos, impl="torch"), dtype)
    kp, vp = _rand(gen, 17, kv, bs, d, dtype=dtype), _rand(gen, 17, kv, bs, d, dtype=dtype)
    tables = torch.randperm(16, generator=gen, device="cuda")[:b * nb].reshape(b, nb).int()
    lens = torch.tensor([0, 33, 79], dtype=torch.int32, device="cuda")
    kn, vn = _rand(gen, b, 1, kv, d, dtype=dtype), _rand(gen, b, 1, kv, d, dtype=dtype)
    args = (q, kp, vp, tables, lens, kn, vn, 80)
    before = pag.DECODE_KERNEL.launches
    _close(ops.paged_decode_attention(*args), ops.paged_decode_attention(*args, impl="torch"),
           dtype)
    assert pag.DECODE_KERNEL.launches == before + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,ctx,g", [(37, 13, 4), (20, 0, 8), (150, 45, 1)])
def test_paged_prefill_kernel_matches_plain(gen, c, ctx, g, dtype):
    kv, d, bs = 2, 64, 8
    nb = max(-(-ctx // bs), 1)
    kp, vp = _rand(gen, nb + 3, kv, bs, d, dtype=dtype), _rand(gen, nb + 3, kv, bs, d, dtype=dtype)
    table = torch.randperm(nb + 2, generator=gen, device="cuda")[:nb].int()
    table = table if ctx else table[:0]
    q = _rand(gen, 1, c, kv * g, d, dtype=dtype)
    ks, vs = _rand(gen, 1, c, kv, d, dtype=dtype), _rand(gen, 1, c, kv, d, dtype=dtype)
    args = (q, kp, vp, table, ctx, ks, vs)
    _close(ops.paged_prefill_attention(*args),
           ops.paged_prefill_attention(*args, impl="torch"), dtype)


def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    q = _rand(gen, 1, 16, 4, 128)
    k = _rand(gen, 1, 16, 4, 128)
    with pytest.raises(ValueError, match="contiguous"):
        fla.flash_attention_cuda(q, k.transpose(1, 2).contiguous().transpose(1, 2), k)
    with pytest.raises(ValueError, match="dtype"):
        fla.flash_attention_cuda(q, k.half(), k)
    with pytest.raises(ValueError, match="head_dim"):
        fla.flash_attention_cuda(q[..., :48].contiguous(), k[..., :48].contiguous(),
                                 k[..., :48].contiguous())
    pos = torch.zeros(1, dtype=torch.int64, device="cuda")
    with pytest.raises(ValueError, match="pos"):
        dec.decode_attention_cuda(q[:, :1], k[:, :1].transpose(1, 2).contiguous(),
                                  k[:, :1].transpose(1, 2).contiguous(), pos)
    with pytest.raises(ValueError, match="CUDA"):
        fla.flash_attention_cuda(q.cpu(), k.cpu(), k.cpu())


def test_blocked_path_refuses_the_card(gen):
    from repro_torch.models.attention import multihead_attention
    from repro_torch.models.config import AttentionConfig
    from repro_torch.models.layers import ExecConfig

    q = _rand(gen, 1, 8, 4, 32)
    with pytest.raises(ValueError, match="CPU only"):
        multihead_attention(q, q, q, AttentionConfig(4, 4, 32), ExecConfig(use_kernels=False))
