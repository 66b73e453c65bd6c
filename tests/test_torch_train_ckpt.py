"""The port's data, weight bridge and checkpoints against the reference's,
on the CPU.

- `data.synthetic_batch` is == to the reference's for the same (seed, step).
- `weights.to_reference(from_reference(x))` is bit-identical to x, for the
  params of all six families (bf16, crossing through a uint16 view) and for
  a whole optimizer state.
- The six cases of tests/test_checkpoint.py on the port's checkpoint module:
  round trip with bf16, LATEST naming the newest, walking back past a
  corrupt or incomplete checkpoint, an empty directory, no torn writes.
- A checkpoint the reference wrote restores in the port, and the reverse:
  the two packages share the on-disk format and the keys.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train_cases import FAMILIES, bridged, np_tree
from repro.training import checkpoint as rckpt
from repro.training import optimizer as ropt
from repro.training.data import synthetic_batch as ref_batch
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.data import DataPipeline, synthetic_batch
from repro_torch.training.optimizer import init_opt_state
from repro_torch.weights import from_reference, to_reference


def _bits_equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype.name == "bfloat16" or b.dtype.name == "bfloat16":
        a, b = a.astype(np.float32), b.astype(np.float32)   # exact widening
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_synthetic_batch_equals_reference(family):
    rcfg, _, cfg, _ = bridged(FAMILIES[family])
    for seed, step in ((0, 0), (3, 17)):
        got, want = synthetic_batch(cfg, 3, 20, seed, step), ref_batch(rcfg, 3, 20, seed, step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    pipe = DataPipeline(cfg, batch=3, seq=20, seed=3, start_step=5, device="cpu",
                        dtype=torch.float32)
    pipe.seek(17)
    placed = next(pipe)
    assert pipe.step == 18
    for k, v in ref_batch(rcfg, 3, 20, 3, 17).items():
        assert np.array_equal(placed[k].numpy(), v)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_weights_round_trip_bit_identical(family):
    rcfg, rparams, cfg, _ = bridged(FAMILIES[family], dtype="bfloat16")
    back = to_reference(from_reference(rparams, cfg, device="cpu"), cfg)
    flat = jax.tree_util.tree_flatten_with_path(rparams)[0]
    assert len(flat) == len(jax.tree.leaves(back))
    for path, want in flat:
        got = back
        for k in path:
            got = got[k.key]
        assert _bits_equal(got, want), jax.tree_util.keystr(path)


def test_optimizer_state_round_trip_bit_identical():
    rcfg, rparams, cfg, _ = bridged("zamba2-2.7b", dtype="bfloat16")
    rstate = np_tree(ropt.init_opt_state(jax.tree.map(jnp.asarray, rparams)))
    rstate["m"] = jax.tree.map(lambda a: a + 0.5, rstate["m"])
    state = from_reference(rstate, cfg, device="cpu")
    assert state["step"].dtype == torch.int32 and len(state["m"]["layers"]) == cfg.num_layers
    back = to_reference(state, cfg)
    for (path, want), got in zip(jax.tree_util.tree_flatten_with_path(rstate)[0],
                                 jax.tree.leaves(back)):
        assert _bits_equal(got, want), jax.tree_util.keystr(path)


# ---------------------------------------------------------------------------
# the six checkpoint cases of tests/test_checkpoint.py, on the port
# ---------------------------------------------------------------------------
def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(4, 8, generator=g).to(torch.bfloat16),
                       "b": torch.arange(8, dtype=torch.float32)},
            "opt": {"step": torch.tensor(7, dtype=torch.int32)}}


def _leaves(tree):
    return [tree[k] for k in sorted(tree) if not isinstance(tree[k], dict)] + \
        [x for k in sorted(tree) if isinstance(tree[k], dict) for x in _leaves(tree[k])]


def test_roundtrip_including_bf16(tmp_path):
    tree = _tree()
    ckpt.save(str(tmp_path), 7, tree)
    step, got = ckpt.restore_latest(str(tmp_path), tree)
    assert step == 7
    for a, b in zip(_leaves(got), _leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_latest_points_to_newest(tmp_path):
    ckpt.save(str(tmp_path), 10, _tree(0))
    ckpt.save(str(tmp_path), 20, _tree(1))
    step, got = ckpt.restore_latest(str(tmp_path), _tree())
    assert step == 20
    assert torch.equal(got["params"]["w"], _tree(1)["params"]["w"])


def test_corrupt_checkpoint_falls_back(tmp_path):
    ckpt.save(str(tmp_path), 10, _tree(0))
    ckpt.save(str(tmp_path), 20, _tree(1))
    newest = os.path.join(str(tmp_path), "step_00000020", "leaf_000000.npy")
    arr = np.load(newest)
    np.save(newest, np.zeros_like(arr))
    step, got = ckpt.restore_latest(str(tmp_path), _tree())
    assert step == 10                      # walked back past the corrupt one
    assert torch.equal(got["params"]["w"], _tree(0)["params"]["w"])


def test_missing_leaf_falls_back(tmp_path):
    ckpt.save(str(tmp_path), 5, _tree(0))
    ckpt.save(str(tmp_path), 6, _tree(1))
    os.remove(os.path.join(str(tmp_path), "step_00000006", "leaf_000001.npy"))
    step, _ = ckpt.restore_latest(str(tmp_path), _tree())
    assert step == 5


def test_restore_empty_dir(tmp_path):
    step, tree = ckpt.restore_latest(str(tmp_path / "nope"), _tree())
    assert step is None and tree is None


def test_no_torn_writes(tmp_path):
    """Nothing step-named exists until the atomic rename completes."""
    ckpt.save(str(tmp_path), 3, _tree())
    entries = os.listdir(str(tmp_path))
    assert "step_00000003" in entries and "LATEST" in entries
    assert not any(e.startswith(".tmp") for e in entries)
    with open(os.path.join(str(tmp_path), "LATEST")) as f:
        assert f.read().strip() == "step_00000003"
    with open(os.path.join(str(tmp_path), "step_00000003", "manifest.json")) as f:
        man = json.load(f)
    assert len(man["leaves"]) == 3 and all("crc32" in e for e in man["leaves"])
    assert [e["key"] for e in man["leaves"]] == ["opt/step", "params/b", "params/w"]
    assert man["leaves"][2]["dtype"] == "bfloat16"


# ---------------------------------------------------------------------------
# across the two packages
# ---------------------------------------------------------------------------
def _model_state(arch="llama-300m"):
    rcfg, rparams, cfg, params = bridged(arch, dtype="bfloat16")
    rstate = ropt.init_opt_state(jax.tree.map(jnp.asarray, rparams))
    rstate = {**rstate, "step": jnp.int32(6),
              "m": jax.tree.map(lambda a: a + 0.25, rstate["m"])}
    return cfg, {"params": rparams, "opt": np_tree(rstate)}


def test_a_reference_checkpoint_restores_in_the_port(tmp_path):
    cfg, rtree = _model_state()
    rckpt.save(str(tmp_path), 6, jax.tree.map(jnp.asarray, rtree))
    like = {"params": from_reference(rtree["params"], cfg, device="cpu")}
    like["opt"] = init_opt_state(like["params"])
    step, got = ckpt.restore_latest(str(tmp_path), like)
    assert step == 6
    assert int(got["opt"]["step"]) == 6 and got["opt"]["step"].dtype == torch.int32
    back = to_reference(got, cfg)
    for (path, want), g in zip(jax.tree_util.tree_flatten_with_path(rtree)[0],
                               jax.tree.leaves(back)):
        assert _bits_equal(g, want), jax.tree_util.keystr(path)
    assert got["params"]["layers"][0]["attn"]["wq"].dtype == torch.bfloat16


def test_a_port_checkpoint_restores_in_the_reference(tmp_path):
    cfg, rtree = _model_state("zamba2-2.7b")
    tree = from_reference(rtree, cfg, device="cpu")
    ckpt.save(str(tmp_path), 6, tree)
    like = jax.tree.map(lambda a: jnp.zeros_like(jnp.asarray(a)), rtree)
    step, got = rckpt.restore_latest(str(tmp_path), like)
    assert step == 6
    for (path, want), g in zip(jax.tree_util.tree_flatten_with_path(rtree)[0],
                               jax.tree.leaves(got)):
        assert _bits_equal(g, want), jax.tree_util.keystr(path)
        assert np.asarray(g).dtype == np.asarray(want).dtype
    # the same files, key for key: the reference's own save of this tree
    rckpt.save(str(tmp_path / "ref"), 6, jax.tree.map(jnp.asarray, rtree))
    with open(tmp_path / "step_00000006" / "manifest.json") as f:
        mine = json.load(f)
    with open(tmp_path / "ref" / "step_00000006" / "manifest.json") as f:
        theirs = json.load(f)
    assert mine == theirs
