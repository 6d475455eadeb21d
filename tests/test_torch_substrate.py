"""The port's substrate modules that this repository's session runtime and
training loop share: the token pipeline (``data/pipeline.py``), the
checkpointer, the fault-tolerant restart loop and the straggler monitor —
the matching cases of ``tests/test_substrate.py`` plus parity with the
reference (same batches, same boundaries, checkpoints that cross between
the packages with the same leaf keys)."""

import collections
import os

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.checkpointer import Checkpointer, _flatten_with_paths
from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
from repro_torch.runtime.fault import FailureInjector, run_with_restarts
from repro_torch.runtime.straggler import StragglerConfig, StragglerMonitor


# ---------------------------------------------------------------- pipeline
def test_pipeline_deterministic_and_restartable():
    cfg = PipelineConfig(vocab_size=1000, global_batch=8, seq_len=32)
    p1 = TokenPipeline(cfg)
    b5a = p1.batch_at(5)
    p2 = TokenPipeline(cfg)
    b5b = p2.batch_at(5)
    np.testing.assert_array_equal(b5a["tokens"], b5b["tokens"])
    # labels are next-token shifted
    np.testing.assert_array_equal(b5a["tokens"][:, 1:], b5a["labels"][:, :-1])


def test_pipeline_host_sharding_partition():
    rows = []
    for host in range(4):
        cfg = PipelineConfig(vocab_size=100, global_batch=16, seq_len=8,
                             num_hosts=4, host_id=host)
        p = TokenPipeline(cfg)
        lo, hi = p.host_rows()
        rows.extend(range(lo, hi + 1))
        b = p.batch_at(0)
        assert b["tokens"].shape[0] == hi - lo + 1
    assert sorted(rows) == list(range(16))


def test_pipeline_prefetch_iterator():
    cfg = PipelineConfig(vocab_size=100, global_batch=4, seq_len=8, prefetch=2)
    p = TokenPipeline(cfg).start(step=3)
    b = next(p)
    ref = p.batch_at(3)
    np.testing.assert_array_equal(b["tokens"], ref["tokens"])
    p.stop()


@pytest.mark.parametrize("structured", [True, False])
def test_pipeline_batches_equal_reference(structured):
    from repro.data.pipeline import (
        PipelineConfig as RefConfig,
        TokenPipeline as RefPipeline,
    )

    kw = dict(vocab_size=500, global_batch=8, seq_len=16, num_hosts=2,
              host_id=1, structured=structured)
    got, want = TokenPipeline(PipelineConfig(**kw)), RefPipeline(RefConfig(**kw))
    for step in (0, 7):
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(got.batch_at(step)[k],
                                          want.batch_at(step)[k])


# -------------------------------------------------------------- checkpoint
def test_checkpoint_roundtrip_and_keep(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2, async_save=False)
    tree = {"a": torch.arange(6.0).reshape(2, 3), "b": {"c": torch.ones(4)}}
    for step in [10, 20, 30]:
        ck.save(step, {"a": tree["a"] + step, "b": {"c": tree["b"]["c"] + step}},
                {"note": step})
    assert ck.all_steps() == [20, 30]  # keep=2
    restored, meta, step = ck.restore(tree, device="cpu")
    assert step == 30 and meta["note"] == 30
    np.testing.assert_allclose(restored["a"].numpy(), (tree["a"] + 30).numpy())
    assert restored["b"]["c"].dtype == torch.float32


def test_checkpoint_shape_mismatch_raises(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save(1, {"a": torch.ones(4)})
    with pytest.raises(ValueError):
        ck.restore({"a": torch.ones(5)}, device="cpu")


def test_checkpoint_atomicity(tmp_path):
    """A leftover .tmp dir is never listed as a valid step."""
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save(7, {"a": torch.ones(2)})
    os.makedirs(os.path.join(str(tmp_path), "step_00000099.tmp"))
    assert ck.all_steps() == [7]
    assert ck.latest_step() == 7


def test_checkpoint_async_save_and_default_device(tmp_path, monkeypatch):
    """An async save lands after ``wait``; a restore with no device means
    the card, and raises where there is none."""
    ck = Checkpointer(str(tmp_path))
    ck.save(3, {"w": torch.full((2, 2), 3.0)})
    ck.wait()
    assert ck.latest_step() == 3
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ck.restore({"w": torch.zeros(2, 2)})


_NT = collections.namedtuple("_NT", "x y")


def _tree(np_mod):
    return {
        "z": np_mod.arange(3.0),
        "a": [np_mod.ones((2, 2)), _NT(np_mod.zeros(1), None)],
        "m": {"k2": np_mod.full((1,), 2.0), "k1": np_mod.full((1,), 1.0)},
    }


def test_leaf_keys_equal_jax_flatten():
    """The port flattens as ``jax.tree`` does: sorted dict keys, sequence
    indices, named-tuple fields, ``None`` as an empty subtree."""
    import jax

    from repro.checkpoint.checkpointer import _flatten_with_paths as ref_flat

    got = _flatten_with_paths(_tree(np))
    want = ref_flat(jax.tree.map(np.asarray, _tree(np)))
    assert [k for k, _ in got] == [k for k, _ in want]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_checkpoint_crosses_packages(tmp_path, writer):
    import jax.numpy as jnp

    from repro.checkpoint.checkpointer import Checkpointer as RefCheckpointer

    tree_t = {"p": torch.arange(6.0).reshape(2, 3),
              "s": {"step": torch.tensor(4, dtype=torch.int32)}}
    tree_j = {"p": jnp.arange(6.0).reshape(2, 3),
              "s": {"step": jnp.asarray(4, jnp.int32)}}
    if writer == "repro":
        RefCheckpointer(str(tmp_path), async_save=False).save(5, tree_j, {"w": 1})
        got, meta, step = Checkpointer(str(tmp_path)).restore(tree_t,
                                                              device="cpu")
        assert got["s"]["step"].dtype == torch.int32
        a, b = got["p"].numpy(), np.asarray(tree_j["p"])
    else:
        Checkpointer(str(tmp_path), async_save=False).save(5, tree_t, {"w": 1})
        got, meta, step = RefCheckpointer(str(tmp_path)).restore(tree_j)
        a, b = np.asarray(got["p"]), tree_t["p"].numpy()
    assert (meta, step) == ({"w": 1}, 5)
    np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------------- fault
def test_run_with_restarts_recovers_from_injected_failure(tmp_path):
    """An injected failure mid-run restores the latest checkpoint and
    replays from its step: the run ends where an uninterrupted one does."""
    ck = Checkpointer(str(tmp_path), async_save=False)

    def step(state, i):
        return {"acc": state["acc"] + float(i)}

    run = run_with_restarts(
        total_steps=10,
        make_state=lambda: {"acc": torch.zeros(())},
        train_step=step,
        checkpointer=ck,
        save_every=3,
        state_device="cpu",
        injector=FailureInjector(fail_at_steps=(7,)),
    )
    assert run.step == 10 and run.restarts == 1
    assert run.history[0][0] == 7
    final, _, last = ck.restore({"acc": torch.zeros(())}, device="cpu")
    assert last == 10 and float(final["acc"]) == float(sum(range(10)))


# --------------------------------------------------------------- straggler
def test_straggler_monitor_rebalances():
    mon = StragglerMonitor(4, 64, StragglerConfig(cooldown_steps=2,
                                                  trigger_imbalance=0.1))
    new = None
    for _ in range(12):
        new = mon.observe([1.0, 1.0, 1.0, 3.0]) or new
    assert new is not None
    sizes = [hi - lo + 1 for lo, hi in new]
    assert sizes[3] < 16  # the slow host got fewer rows
    assert sum(sizes) == 64
    assert new[0][0] == 0 and new[-1][1] == 63


def test_straggler_monitor_stable_when_balanced():
    mon = StragglerMonitor(4, 64, StragglerConfig(cooldown_steps=2))
    for _ in range(10):
        assert mon.observe([1.0, 1.01, 0.99, 1.0]) is None


def test_straggler_boundaries_equal_reference():
    from repro.runtime.straggler import (
        StragglerConfig as RefConfig,
        StragglerMonitor as RefMonitor,
    )

    rng = np.random.default_rng(9)
    got = StragglerMonitor(6, 96, StragglerConfig(cooldown_steps=2))
    want = RefMonitor(6, 96, RefConfig(cooldown_steps=2))
    for _ in range(20):
        t = list(rng.uniform(0.8, 2.0, 6))
        assert got.observe(t) == want.observe(t)
        assert got.imbalance() == want.imbalance()
    assert got.bounds == want.bounds


def test_registration_app_config_equals_reference():
    import dataclasses

    from repro.configs import registration as ref_cfg
    from repro_torch.configs import registration as cfg

    for name in ("CONFIG", "SMOKE"):
        assert dataclasses.asdict(getattr(cfg, name)) == dataclasses.asdict(
            getattr(ref_cfg, name))
