"""The plain reference against repro_torch on reduced dense and MoE configs,
on the CPU in fp32: the logits of a prompt agree, and the tokens the engine
serves through a whole open-loop run are the reference's best, with the
MoE's dispatch groups rebuilt from the run's token timeline (each through
its family module, perfbench/families)."""
import functools

import numpy as np
import perfbench_cases as cases
import pytest
import torch

from perfbench.harness import check, spec
from perfbench.reference import model as ref
from repro_torch.models import backbone
from repro_torch.models.layers import ExecConfig

ARCHS = ["yi-6b", "qwen2-moe-a2.7b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_prompt_logits_match_the_program(arch):
    cfg = cases.config(arch)
    fam = spec.family(cfg["family"])
    w = fam.make_weights(cfg, 2 ** 31 + 3, "cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg["vocab_size"], 37))
    got, _ = backbone.prefill(fam.program_params(w, cfg), {"tokens": toks[None]},
                              fam.model_config(cfg), ExecConfig())
    ffn = ref.swiglu
    if cfg["family"] == "moe":
        ffn = functools.partial(ref.moe, cfg=cfg,
                                groups=ref.flat_groups([[(0, torch.arange(37))]], [37], "cpu"))
    want = ref.logits(w, cfg, [toks], [torch.tensor([36])], ffn)[0]
    torch.testing.assert_close(got.float(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_served_tokens_are_the_references_best(arch, monkeypatch):
    cases.fake_clock(monkeypatch)
    run = cases.run_module()
    cell = cases.cell(arch, arrivals="backlog" if arch.startswith("qwen") else "poisson",
                      lead_s=0.3, max_batch=8)
    view, w, served = run.serve(cell, 2 ** 31 + 11, 1.5, False, device="cpu")
    done = [s for s in served if s.finished]
    assert len(done) >= 4 and sum(len(s.times) for s in done) >= 20
    r = check.judge(cell.family, w, cell.config, served, done)
    assert r["max_gap"] == 0.0 and r["agree"] == 1.0
    if arch.startswith("qwen"):
        # the decode groups matter: with the group order reversed, tokens
        # dropped for capacity change and the served tokens stop agreeing
        seqs = [s for s in served if s.times]
        groups = cell.family.moe_groups(seqs)
        flips = [g[::-1] if len(g) > 1 else g for g in groups]
        rows = [torch.arange(len(s.prompt) - 1, len(s.prompt) - 1 + len(s.times)) for s in seqs]
        feed = [check.fed(s) for s in seqs]
        lens = [int(f.numel()) for f in feed]

        def moe(g):
            return functools.partial(ref.moe, cfg=cell.config,
                                     groups=ref.flat_groups(g, lens, "cpu"))
        a = ref.logits(w, cell.config, feed, rows, moe(groups))
        b = ref.logits(w, cell.config, feed, rows, moe(flips))
        assert max(float((x - y).abs().max()) for x, y in zip(a, b)) > 1e-3


def test_capacity_and_rank_by_hand():
    cfg = {"num_experts": 4, "num_experts_per_tok": 2, "capacity_factor": 1.25}
    assert ref.capacity(8, cfg) == 5 and ref.capacity(1, cfg) == 2
    # 64 decode tokens of qwen2-moe-a2.7b: int(64 * 4 * 1.25 / 60) = 5 slots
    moe = {"num_experts": 60, "num_experts_per_tok": 4, "capacity_factor": 1.25}
    assert ref.capacity(64, moe) == 5 and ref.capacity(510, moe) == 42


def test_fp8_control_rounds_to_three_mantissa_bits():
    x = torch.tensor([[1.0, 1.0625, 448.0, -3.3]])
    y = ref._fp8(x, dim=-1)
    assert y[0, 0] == 1.0 and y[0, 2] == 448.0 and y[0, 1] != x[0, 1]
    assert float((y - x).abs().max() / x.abs().max()) < 2 ** -4
