"""The port's training substrates against the JAX package's, on the CPU:
the data pipeline, the checkpointer (its on-disk layout shared with the
reference's in both directions), straggler detection and the
fault-tolerant loop.

  * `TokenPipeline` batches equal the reference's element for element for
    the synthetic, frontend, encoder-decoder, host-sharded and `file`
    (a temporary uint16 memmap) sources, and after `restore`;
  * a checkpoint of `(params, adamw_init(params))` of smollm-360m's smoke
    tree written by the reference's `Checkpointer` restores in the port
    bitwise, with the same manifest (leaf names, files, shapes, dtypes,
    bf16 as its raw words), and the port's checkpoint restores in the
    reference bitwise; so do DeepSeek-V2-Lite's (MLA + MoE, its f32
    router), mamba2's, Jamba's and seamless's smoke trees;
  * atomic publish (a stray `.tmp` is never a step), keep-k GC, an async
    save's error raised at the next `wait()`, metadata round trips; a
    restore keeps a bf16 leaf over an f32 target and refuses any other
    dtype that differs;
  * `StragglerDetector` flags the reference's steps on one seeded series;
  * the port's `FaultTolerantLoop`: a crash at step 6 and a restart from
    the step-4 checkpoint end bitwise where the uninterrupted run ends
    (parameters and optimizer state), as `tests/test_substrates.py` holds
    the reference; a preemption saves a blocking checkpoint and stops.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import Checkpointer as JCheckpointer
from repro.data import DataConfig as JDataConfig
from repro.data import TokenPipeline as JTokenPipeline
from repro.models import registry as jregistry
from repro.optim import adamw_init as jadamw_init
from repro.runtime import StragglerDetector as JStragglerDetector
from repro_torch import configs, convert, tree
from repro_torch.checkpoint import Checkpointer
from repro_torch.checkpoint import checkpointer as ckpt_mod
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.launch import steps
from repro_torch.models import registry
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.runtime import FaultTolerantLoop, PreemptionGuard, StragglerDetector
from tests.torch_parity import to_np, torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")


def _batches(pipe_cls, cfg_cls, n=4, **kw):
    pipe = pipe_cls(cfg_cls(**kw))
    try:
        out = [next(pipe) for _ in range(n)]
        return out, pipe.state()
    finally:
        pipe.close()


SOURCES = {
    "synthetic": dict(seq_len=32, global_batch=4, vocab=256, seed=7),
    "frontend": dict(seq_len=40, global_batch=2, vocab=512, seed=3, frontend_tokens=8,
                     d_model=16),
    "encdec": dict(seq_len=24, global_batch=2, vocab=300, seed=5, encdec=True, d_model=12),
    "host1of2": dict(seq_len=16, global_batch=8, vocab=128, seed=3, host_id=1, num_hosts=2),
}


@pytest.mark.parametrize("source", sorted(SOURCES))
def test_pipeline_batches_match_reference(source):
    kw = SOURCES[source]
    want, want_state = _batches(JTokenPipeline, JDataConfig, **kw)
    got, got_state = _batches(TokenPipeline, DataConfig, **kw)
    assert got_state == want_state
    for w, g in zip(want, got):
        assert sorted(w) == sorted(g)
        for k in w:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k
    # resume: the restored pipeline continues as the reference's does
    jp, tp = JTokenPipeline.restore(JDataConfig(**kw), want_state), \
        TokenPipeline.restore(DataConfig(**kw), got_state)
    try:
        for _ in range(2):
            w, g = next(jp), next(tp)
            assert all(np.array_equal(g[k], w[k]) for k in w)
    finally:
        jp.close()
        tp.close()


def test_pipeline_file_source_matches_reference(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 1000, 5000).astype(np.uint16).tofile(path)
    kw = dict(seq_len=20, global_batch=3, vocab=700, seed=2, source="file", path=str(path))
    want, _ = _batches(JTokenPipeline, JDataConfig, **kw)
    got, _ = _batches(TokenPipeline, DataConfig, **kw)
    for w, g in zip(want, got):
        assert np.array_equal(g["tokens"], w["tokens"]) and np.array_equal(g["labels"],
                                                                           w["labels"])
        assert g["tokens"].max() < 700   # clipped to the vocab


@pytest.fixture(scope="module")
def smoke_state():
    jcfg = jconfigs.get_arch("smollm-360m", smoke=True)
    with jax.threefry_partitionable(True):
        jparams = jax.device_get(jregistry.materialize_params(jcfg, seed=0))
    jstate = jax.device_get((jparams, jadamw_init(jparams)))
    cfg = configs.get_arch("smollm-360m", smoke=True)
    params = convert.from_jax_params(jparams, cfg, device="cpu")
    return jstate, (params, adamw_init(params))


def _manifest(d, step):
    return json.loads((d / f"step_{step:010d}" / "manifest.json").read_text())


def test_checkpoint_moves_between_packages(smoke_state, tmp_path):
    jstate, state = smoke_state
    JCheckpointer(tmp_path / "jax").save(3, jstate, {"step": 3, "data_state": {"step": 3}},
                                        blocking=True)
    ck = Checkpointer(tmp_path / "port")
    ck.save(3, state, {"step": 3, "data_state": {"step": 3}}, blocking=True)
    mj, mt = _manifest(tmp_path / "jax", 3), _manifest(tmp_path / "port", 3)
    assert mj["leaves"] == mt["leaves"] and mj["metadata"] == mt["metadata"]
    assert any(r["dtype"] == "bfloat16" for r in mt["leaves"])
    assert [r["name"] for r in mt["leaves"]][:2] == ["0/embed", "0/final_norm"]
    assert mt["leaves"][-1]["name"] == "1/count"
    # the reference's checkpoint in the port
    fresh = tree.tree_map(torch.zeros_like, state)
    restored, meta = Checkpointer(tmp_path / "jax").restore(3, fresh)
    assert meta == {"step": 3, "data_state": {"step": 3}}
    for (name, want), got in zip(tree.named_leaves(state), tree.leaves(restored)):
        assert got.dtype == want.dtype and torch.equal(got, want), name
    # the port's checkpoint in the reference
    jrestored, _ = JCheckpointer(tmp_path / "port").restore(3, jstate)
    for want, got in zip(jax.tree_util.tree_leaves(jstate), jax.tree_util.tree_leaves(jrestored)):
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "mamba2-2.7b", "jamba-v0.1-52b",
                                  "seamless-m4t-medium"])
def test_family_checkpoints_move_between_packages(arch, tmp_path):
    """The MLA + MoE, SSD, hybrid and encoder-decoder smoke trees with their
    AdamW state: the reference's checkpoint restores in the port bitwise,
    the port's in the reference, with the same manifest."""
    jcfg = jconfigs.get_arch(arch, smoke=True)
    with jax.threefry_partitionable(True):
        jparams = jax.device_get(jregistry.materialize_params(jcfg, seed=0))
    jstate = jax.device_get((jparams, jadamw_init(jparams)))
    params = convert.from_jax_params(jparams, configs.get_arch(arch, smoke=True), device="cpu")
    state = (params, adamw_init(params))
    JCheckpointer(tmp_path / "jax").save(2, jstate, {"step": 2}, blocking=True)
    Checkpointer(tmp_path / "port").save(2, state, {"step": 2}, blocking=True)
    assert _manifest(tmp_path / "jax", 2)["leaves"] == _manifest(tmp_path / "port", 2)["leaves"]
    restored, _ = Checkpointer(tmp_path / "jax").restore(2, tree.tree_map(torch.zeros_like, state))
    for (name, want), got in zip(tree.named_leaves(state), tree.leaves(restored)):
        assert got.dtype == want.dtype and torch.equal(got, want), name
    jrestored, _ = JCheckpointer(tmp_path / "port").restore(2, jstate)
    for want, got in zip(jax.tree_util.tree_leaves(jstate), jax.tree_util.tree_leaves(jrestored)):
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_checkpoint_gc_atomic_and_metadata(tmp_path):
    t = {"a": torch.arange(12.0).reshape(3, 4),
         "b": [torch.ones(2, dtype=torch.int32), torch.zeros(5, dtype=torch.bfloat16)]}
    ck = Checkpointer(tmp_path, keep=2)
    for step in (10, 20, 30):
        ck.save(step, t, {"step": step})
    ck.wait()
    assert ck.all_steps() == [20, 30]        # keep-2 GC
    os.makedirs(tmp_path / "step_0000000040.tmp")
    assert ck.latest() == 30                 # a stray .tmp is never a step
    restored, meta = ck.restore(30, t)
    assert meta == {"step": 30}
    assert torch.equal(restored["a"], t["a"]) and restored["b"][1].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="leaves"):
        ck.restore(30, {"a": t["a"]})


def test_restore_keeps_bf16_over_f32_and_refuses_other_dtypes(tmp_path):
    """A leaf saved in bf16 where the target holds f32 (a trained MoE
    router restored into a fresh tree) keeps bf16; any other dtype that
    differs from the target's raises, naming the leaf."""
    saved = {"router": torch.linspace(-2, 2, 6, dtype=torch.bfloat16), "w": torch.ones(3)}
    ck = Checkpointer(tmp_path)
    ck.save(1, saved, blocking=True)
    restored, _ = ck.restore(1, {"router": torch.zeros(6), "w": torch.zeros(3)})
    assert restored["router"].dtype == torch.bfloat16
    assert torch.equal(restored["router"], saved["router"]) and torch.equal(restored["w"], saved["w"])
    restored["w"].add_(1.0)   # a restored host leaf is writable, its file unchanged
    assert torch.equal(ck.restore(1, saved)[0]["w"], torch.ones(3))
    with pytest.raises(ValueError, match="leaf w is torch.float32, the target's torch.bfloat16"):
        ck.restore(1, {"router": torch.zeros(6), "w": torch.zeros(3, dtype=torch.bfloat16)})
    with pytest.raises(ValueError, match="leaf router is torch.bfloat16, the target's torch.int32"):
        ck.restore(1, {"router": torch.zeros(6, dtype=torch.int32), "w": torch.zeros(3)})


def test_checkpoint_snapshot_is_a_copy(tmp_path):
    """save() copies at once: a later in-place write does not reach the file."""
    x = torch.ones(4)
    ck = Checkpointer(tmp_path)
    ck.save(1, {"x": x})
    x.add_(1.0)
    ck.wait()
    restored, _ = ck.restore(1, {"x": torch.zeros(4)})
    assert torch.equal(restored["x"], torch.ones(4))


def test_async_save_error_surfaces_at_wait(tmp_path, monkeypatch):
    def boom(x):
        raise OSError("disk full")

    ck = Checkpointer(tmp_path)
    monkeypatch.setattr(ckpt_mod, "_to_savable", boom)
    ck.save(1, {"x": torch.ones(3)})          # returns: the write runs in a thread
    with pytest.raises(OSError, match="disk full"):
        ck.wait()
    ck.wait()                                 # reported once
    assert ck.latest() is None


def test_straggler_detector_matches_reference():
    rng = np.random.default_rng(0)
    series = 0.10 + rng.normal(size=200) * 0.003
    series[[30, 77, 150]] = (0.50, 0.2, 0.13)
    jd, td = JStragglerDetector(warmup=4), StragglerDetector(warmup=4)
    flags = [(jd.observe(i, dt), td.observe(i, dt)) for i, dt in enumerate(series)]
    assert [f[0] for f in flags] == [f[1] for f in flags]
    assert flags[30] == (True, True)
    assert jd.events == td.events and jd.mean == td.mean


def _tiny_setup():
    cfg = configs.get_arch("smollm-360m", smoke=True)
    params = registry.materialize_params(cfg, 0, device="cpu")
    step = steps.make_train_step(cfg, AdamWConfig(lr=1e-3), q_block=16)

    def step_fn(state, batch):
        p, o, met = step(*state, {k: torch.from_numpy(v) for k, v in batch.items()})
        return (p, o), {"loss": met["loss"].item()}

    dcfg = DataConfig(seq_len=32, global_batch=4, vocab=cfg.vocab, seed=1)
    return (params, adamw_init(params)), step_fn, dcfg


def test_crash_restart_bit_exact(tmp_path):
    state0, step_fn, dcfg = _tiny_setup()
    pipe = TokenPipeline(dcfg)
    ref_state, _, ref_hist = FaultTolerantLoop(step_fn, Checkpointer(tmp_path / "ref"),
                                               checkpoint_every=4, max_steps=10).run(
        tree.tree_map(torch.clone, state0), pipe, 0)   # a step updates its state in place
    pipe.close()

    ck = Checkpointer(tmp_path / "crash")
    pipe = TokenPipeline(dcfg)
    loop = FaultTolerantLoop(step_fn, ck, checkpoint_every=4, max_steps=10, fail_at_step=6)
    with pytest.raises(RuntimeError, match="injected failure"):
        loop.run(state0, pipe, 0)
    pipe.close()
    ck.wait()
    loop2 = FaultTolerantLoop(step_fn, ck, checkpoint_every=4, max_steps=10)
    state, start, data_state = loop2.resume_or(tree.tree_map(torch.zeros_like, state0))
    assert start == 4 and data_state == {"step": 4, "seed": 1}
    pipe2 = TokenPipeline.restore(dcfg, data_state)
    state, last, hist = loop2.run(state, pipe2, start)
    pipe2.close()
    assert last == 10 and [h["loss"] for h in hist] == [h["loss"] for h in ref_hist[4:]]
    for a, b in zip(tree.leaves(ref_state), tree.leaves(state)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert ref_hist[-1]["loss"] < ref_hist[0]["loss"]


def test_preemption_saves_and_stops(tmp_path):
    state0, step_fn, dcfg = _tiny_setup()
    guard = PreemptionGuard(install=False)
    ck = Checkpointer(tmp_path)
    pipe = TokenPipeline(dcfg)

    def preempt_after_two(step, metrics):
        guard.preempted = step >= 2

    _, last, hist = FaultTolerantLoop(step_fn, ck, checkpoint_every=100, max_steps=10,
                                      preemption_guard=guard).run(
        state0, pipe, 0, metrics_cb=preempt_after_two)
    pipe.close()
    assert last == 2 and len(hist) == 2 and ck.latest() == 2
    assert _manifest(tmp_path, 2)["metadata"] == {"step": 2, "data_state": {"step": 2, "seed": 1}}
    assert to_np(state0[1].count) == 0
