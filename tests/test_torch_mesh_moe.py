"""The MoE and the pod axis on a mesh, over gloo on 8 CPU ranks, held to
the JAX package's mesh step on 8 fake devices (`tests/mesh_reference.py`,
one child process) and to the port's one-process step.

  * One MoE layer of DeepSeek-V2-Lite's smoke config (4 experts, top 2,
    one shared expert) on seeded bf16 tokens whose router sends most pairs
    to expert 0: the port's `moe_ffn` at 4 x 2 (each rank its 2 rows and
    its 2 experts, the capacity from its 32 tokens, the partial outputs
    summed over `model` in bf16) equals the reference's `moe_ffn` under
    its 4 x 2 mesh BITWISE: the output, every rank's capacity (20) and its
    dropped pairs (10-11 on each model-0 rank, counted from the
    reference's router).  Bitwise because each shard's dispatch adds its
    experts' contributions in the reference's order and rounding, and the
    sum of two bf16 partials rounds once on either side.
  * The reference test's own case (`tests/test_sharding.py`):
    DeepSeek-V2-Lite smoke, seq 64, batch 8, grad_accum 2, q_block 32, 3
    steps of `make_train_step(cfg, mesh)` in each package from the
    reference's `materialize_params(cfg, 0)` and `materialize_batch`: each
    loss within 2e-3 relative of the reference's (readings 2.0e-4 to
    5.2e-4: the reference's program is jitted and partitioned by GSPMD, the
    port's op by op), and falling.
  * The same case from the same parameters cast to f32, one step, where
    both programs compute in f32 and can differ only by the order of f32
    sums: the metrics within 1e-5 relative (readings: 6.2e-6 at most, the
    grad norm) and every leaf of the state after the step, reassembled
    from the ranks' blocks (the MLA heads and the experts split over
    `model`, FSDP and ZeRO-1 over `data`), within 1e-4 relative L2
    (readings: parameters 1.7e-5, master 1.3e-5, m 5.7e-5, v 6.9e-5).  m
    after one step is the clipped gradient times 0.1, so this holds every
    gradient block to the reference's.  The bf16 state after the 3 steps
    above is not compared: at the reference's raw init (not
    `common.fan_in_init`) the first step's bf16 roundings, taken in
    another order, move m and v after 3 steps by 0.06 to 0.94 relative L2
    and the parameters by up to 2.1e-2, though the losses agree.
  * The pod axis: yi-6b smoke at 2 x 2 x 2 ("pod", "data", "model"), 3
    steps against the one-process step within `tests/test_torch_mesh_step.py`'s
    tolerances (f32 and bf16); `compressed_psum_leaf` over `pod` equals the
    mean of the two pod ranks' dequantized codes.
"""

import concurrent.futures
import pickle

import numpy as np
import pytest
import torch

from tests import mesh_reference as mref
from tests import mesh_worker as mw
from tests.torch_parity import torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")
POD = ("step:yi-6b:2x2x2:1:float32", "step:yi-6b:2x2x2:1:bfloat16")
LOSS_REL = 2e-3
LEAF_REL_L2, SUMMED_REL_L2 = 1.5e-2, 2e-2


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the JAX references, the port's 8-rank results), run at once."""
    import jax
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.configs.base import ShapeConfig
    from repro.models import registry as jregistry

    d = tmp_path_factory.mktemp("mesh8")
    cfg = jconfigs.get_arch("deepseek-v2-lite-16b", smoke=True)
    shp = ShapeConfig("t", mw.DS_SEQ, mw.DS_BATCH, "train")
    params = jregistry.materialize_params(cfg, 0)
    batch = jregistry.materialize_batch(jregistry.train_batch_spec(cfg, shp, jnp.float32), 0,
                                        cfg.vocab)
    with open(d / "ds_in.pkl", "wb") as f:
        pickle.dump({"params": [np.asarray(x).view(np.uint16) if x.dtype == jnp.bfloat16
                                else np.asarray(x) for x in jax.tree_util.tree_leaves(params)],
                     "batch": {k: np.asarray(v) for k, v in batch.items()}}, f)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        ref = pool.submit(mref.run, d / "ref.pkl", ["moe", "ds_step", "ds_step_f32"])
        port = pool.submit(mw.launch, 8, d / "port.pkl",
                           ["moe_layer", f"ds_step:{d / 'ds_in.pkl'}",
                            f"ds_step_f32:{d / 'ds_in.pkl'}", *POD, "psum_pod"])
        return ref.result(), port.result(), str(d / "ds_in.pkl")


def test_moe_layer_matches_reference_bitwise(runs):
    ref, port, _ = runs
    got = port["moe_layer"]
    assert np.array_equal(got["y"], ref["moe"]["y"])
    cap = ref["moe"]["capacity"]
    rows = mref.MOE_B // 4
    e_loc = 2
    for (data, model), rank_cap, drops in got["ranks"]:
        assert rank_cap == cap
        counts = np.bincount(ref["moe"]["eidx"][data * rows:(data + 1) * rows].reshape(-1),
                             minlength=4)[model * e_loc:(model + 1) * e_loc]
        assert drops == int(np.maximum(counts - cap, 0).sum()), (data, model)
    assert sum(d for _, _, d in got["ranks"]) > 0          # the capacity bites


def test_deepseek_mesh_step_matches_reference(runs):
    ref, port, path = runs
    want = ref["ds_step"]["losses"]
    got = port[f"ds_step:{path}"]["losses"]
    for g, w in zip(got, want):
        assert abs(g - w) <= LOSS_REL * w, (got, want)
    assert got[-1] < got[0] and want[-1] < want[0]


def test_deepseek_mesh_step_f32_state_matches_reference(runs):
    ref, port, path = runs
    want, got = ref["ds_step_f32"], port[f"ds_step_f32:{path}"]
    for k, w in want["metrics"].items():
        assert abs(got["metrics"][k] - w) <= mw.F32_METRIC * max(abs(w), 1e-6), (k, got, w)
    assert len(got["state"]) == len(want["state"])
    for (name, g), w in zip(got["state"], want["state"]):
        assert g.shape == w.shape, name
        if g.dtype.kind != "f":
            assert np.array_equal(g, w), name            # the step count
            continue
        assert mw.rel_l2(g, w) <= mw.F32_LEAF, (name, mw.rel_l2(g, w))


@pytest.mark.parametrize("job", POD)
def test_pod_axis_step_matches_one_process(runs, job):
    _, port, _ = runs
    _, arch, _, accum, dtype = job.split(":")
    mw.check(port[job], mw.one_process(arch, int(accum), dtype), dtype)


def test_compressed_psum_over_pod(runs):
    from repro_torch.optim import grad_compress as gc

    got = runs[1]["psum_pod"]
    coords = got["coords"]
    for r, (pod, data, model) in enumerate(coords):
        peers = [i for i, c in enumerate(coords) if c[1:] == (data, model)]
        assert len(peers) == 2 and r in peers
        deq = [gc.dequantize_int8(*gc.quantize_int8(torch.from_numpy(got["inputs"][i])))
               for i in peers]
        want = (deq[0] + deq[1]) / 2
        assert np.array_equal(got["outs"][r], want.numpy()), r
