"""The port's training on a mesh, run by every rank of a gloo world for
`tests/test_torch_mesh_*.py` (not a test file).

    python -m tests.mesh_worker OUT.pkl JOB [JOB ...]   (one process per rank,
                                                       through `launch`)

Each rank runs every job in order; rank 0 pickles {job: result}.  Jobs:
  * `step:<arch>:<DxM or PxDxM>:<grad_accum>:<dtype>` -- the smoke config
    (`smoke_cfg`: an MoE at a capacity where no pair drops)
    at `common.fan_in_init` of its seed-0 draws (cast to f32 for dtype
    float32), `STEPS` steps of the pipeline's `BATCH` x `SEQ` batches
    through `make_train_step(..., mesh=)`, each rank on its rows: every
    step's metrics, and the state reassembled after the last (numpy f32);
  * `moe_layer` -- one MoE layer of DeepSeek-V2-Lite's smoke config on a
    4 x 2 mesh from `tests.mesh_reference.moe_inputs`: the output, each
    rank's capacity and its dropped pairs;
  * `ds_step:<in.pkl>` -- DeepSeek-V2-Lite smoke at 4 x 2, seq 64, batch 8,
    grad_accum 2, q_block 32, 3 steps from the parameters and batch in
    in.pkl (the JAX package's draws): the losses;
  * `ds_step_f32:<in.pkl>` -- the same from the parameters cast to f32,
    one step: its metrics and the state reassembled after it (numpy f32);
  * `psum_pod` -- `compressed_psum_leaf` over `pod` of a 2 x 2 x 2 mesh on
    seeded per-rank floats: each rank's input and the result;
  * `ckpt_write:<dir>` -- 3 steps of yi-6b smoke at 2 x 2, then the state
    saved at step 3 into dir (and the state, reassembled);
  * `ckpt_restore:<dir>:<DxM>` -- `remesh_restore` of dir's checkpoint onto
    a DxM mesh, the state reassembled.

`one_process` runs a `step:` scenario's one-process step, `check` holds a
sharded run to it.
"""

import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
STEPS, BATCH, SEQ, Q_BLOCK, LR = 3, 8, 32, 16, 1e-3
DS_SEQ, DS_BATCH, DS_ACCUM, DS_Q_BLOCK = 64, 8, 2, 32


def mesh_layout(text: str):
    shape = tuple(int(t) for t in text.split("x"))
    return shape, (("pod", "data", "model") if len(shape) == 3 else ("data", "model"))


def batches(cfg, n=STEPS, batch=BATCH, seq=SEQ):
    """The pipeline's first n batches (numpy), as the training CLI draws them."""
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.train import data_config
    pipe = TokenPipeline(data_config(cfg, seq, batch, 0))
    try:
        return [next(pipe) for _ in range(n)]
    finally:
        pipe.close()


def smoke_cfg(arch: str):
    """The smoke config of a `step:` scenario.  An MoE's capacity factor is
    E / top_k, so an expert has a slot for every token: no pair drops,
    with the mesh's per-rank capacity or the one process's, and both steps
    compute one function (with the default factor the mesh drops other
    pairs, as the reference's does: `tests/test_torch_mesh_moe.py` holds
    that case to the JAX package)."""
    import dataclasses
    from repro_torch import configs
    cfg = configs.get_arch(arch, smoke=True)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    return cfg


def start_params(cfg, dtype: str):
    import torch
    from repro_torch import tree as tree_lib
    from repro_torch.models import common, registry
    p = common.fan_in_init(registry.materialize_params(cfg, 0, device="cpu"))
    if dtype == "float32":
        p = tree_lib.tree_map(lambda t: t.float(), p)
    return p


def to_torch(batch):
    import torch
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def as_numpy(tree):
    import torch
    from repro_torch import tree as tree_lib
    return [(n, t.float().numpy() if t.is_floating_point() else t.numpy())
            for n, t in tree_lib.named_leaves(tree)]


def _step_job(arch, layout, accum, dtype):
    import torch
    from repro_torch.launch import mesh as mesh_lib, sharding as shd, steps
    from repro_torch.optim import AdamWConfig

    cfg = smoke_cfg(arch)
    mesh = mesh_lib.make_mesh(*mesh_layout(layout), device_type="cpu")
    p, o = steps.shard_train_state(start_params(cfg, dtype), cfg, mesh)
    step = steps.make_train_step(cfg, AdamWConfig(lr=LR), grad_accum=int(accum),
                                 q_block=Q_BLOCK, mesh=mesh,
                                 param_dtype=getattr(torch, dtype))
    mets = []
    for b in batches(cfg):
        p, o, met = step(p, o, to_torch(steps.local_batch(b, mesh, int(accum))))
        mets.append({k: float(v) for k, v in met.items()})
    state = shd.assemble_tree((p, o), steps.state_specs(cfg, mesh), mesh)
    return {"metrics": mets, "state": as_numpy(state)}


def _moe_layer():
    import torch
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import mlp, parallel
    from tests.mesh_reference import moe_inputs

    cfg = configs.get_arch("deepseek-v2-lite-16b", smoke=True)
    inp = moe_inputs(cfg)
    mesh = mesh_lib.make_mesh((4, 2), ("data", "model"), device_type="cpu")
    bf = lambda a: torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    x = bf(inp["x"])
    rows = x.shape[0] // 4
    x = x[mesh.coord("data") * rows:(mesh.coord("data") + 1) * rows]
    e_loc = cfg.n_experts // 2
    lo = mesh.coord("model") * e_loc
    params = {"router": torch.from_numpy(inp["router"]),
              **{k: bf(inp[k])[lo:lo + e_loc] for k in ("w_gate", "w_up", "w_down")},
              "shared": {k: bf(v) for k, v in inp["shared"].items()}}   # whole
    for k in ("w_gate", "w_up", "w_down"):
        params[k] = params[k].view_as(params[k])
        params[k]._model_split = True
    y = mlp.moe_ffn(params, x, cfg, mesh=mesh, data_axes=("data",))
    # the drops: this rank's pairs past capacity
    b, s, e = x.shape
    _, _, eidx = mlp.route(params, x, cfg)
    cap = mlp.capacity(cfg, b * s)
    local = eidx.reshape(-1) - lo
    mine = local[(local >= 0) & (local < e_loc)]
    drops = int(sum(max(int((mine == j).sum()) - cap, 0) for j in range(e_loc)))
    full = parallel.all_gather_dim(y, 0, mesh, "data")
    per_rank = [None] * dist.get_world_size()
    dist.all_gather_object(per_rank, ((mesh.coord("data"), mesh.coord("model")), cap, drops))
    return {"y": full.view(torch.int16).numpy().view(np.uint16), "ranks": per_rank}


def _ds_step(path, f32: bool = False):
    import torch
    from repro_torch import configs, tree as tree_lib
    from repro_torch.launch import mesh as mesh_lib, sharding as shd, steps
    from repro_torch.models import registry

    with open(path, "rb") as f:
        inp = pickle.load(f)
    cfg = configs.get_arch("deepseek-v2-lite-16b", smoke=True)
    mesh = mesh_lib.make_mesh((4, 2), ("data", "model"), device_type="cpu")
    like = registry.materialize_params(cfg, 0, device="cpu")
    # the leaves in flatten order, the same in both packages (bf16 as uint16)
    params = tree_lib.unflatten(like, [
        torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) if a.dtype == np.uint16
        else torch.from_numpy(a) for a in inp["params"]])
    if f32:
        params = tree_lib.tree_map(lambda t: t.float(), params)
    p, o = steps.shard_train_state(params, cfg, mesh)
    step = steps.make_train_step(cfg, grad_accum=DS_ACCUM, q_block=DS_Q_BLOCK, mesh=mesh)
    batch = to_torch(steps.local_batch(inp["batch"], mesh, DS_ACCUM))
    losses = []
    for _ in range(1 if f32 else 3):
        p, o, met = step(p, o, batch)
        losses.append(float(met["loss"]))
    if not f32:
        return {"losses": losses}
    state = shd.assemble_tree((p, o), steps.state_specs(cfg, mesh), mesh)
    return {"metrics": {k: float(v) for k, v in met.items()}, "state": as_numpy(state)}


def _psum_pod():
    import torch
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.optim import grad_compress as gc
    import torch.distributed as dist

    mesh = mesh_lib.make_mesh((2, 2, 2), ("pod", "data", "model"), device_type="cpu")
    g = torch.from_numpy(np.random.default_rng(dist.get_rank()).standard_normal(
        (5, 7)).astype(np.float32))
    out = gc.compressed_psum_leaf(g, "pod", mesh)
    inputs = [torch.empty_like(g) for _ in range(dist.get_world_size())]
    dist.all_gather(inputs, g)
    coords = [None] * dist.get_world_size()
    dist.all_gather_object(coords, (mesh.coord("pod"), mesh.coord("data"), mesh.coord("model")))
    outs = [torch.empty_like(out) for _ in range(dist.get_world_size())]
    dist.all_gather(outs, out)
    return {"inputs": [t.numpy() for t in inputs], "outs": [t.numpy() for t in outs],
            "coords": coords}


def _ckpt_write(path):
    import torch
    from repro_torch import configs
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.launch import mesh as mesh_lib, sharding as shd, steps
    from repro_torch.optim import AdamWConfig

    cfg = configs.get_arch("yi-6b", smoke=True)
    mesh = mesh_lib.make_mesh((2, 2), ("data", "model"), device_type="cpu")
    p, o = steps.shard_train_state(start_params(cfg, "bfloat16"), cfg, mesh)
    step = steps.make_train_step(cfg, AdamWConfig(lr=LR), q_block=Q_BLOCK, mesh=mesh)
    for b in batches(cfg):
        p, o, _ = step(p, o, to_torch(steps.local_batch(b, mesh)))
    specs = steps.state_specs(cfg, mesh)
    ckpt = Checkpointer(path, mesh=mesh, specs=specs)
    ckpt.save(STEPS, (p, o), {"step": STEPS}, blocking=True)
    ckpt.wait()
    return {"state": as_numpy(shd.assemble_tree((p, o), specs, mesh))}


def _ckpt_restore(path, layout):
    import torch
    from repro_torch import configs
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.launch import sharding as shd, steps
    from repro_torch.models import registry
    from repro_torch.optim import adamw_init
    from repro_torch.runtime.elastic import remesh_restore

    cfg = configs.get_arch("yi-6b", smoke=True)
    params = registry.materialize_params(cfg, 1, device="cpu")
    state, meta, mesh = remesh_restore(Checkpointer(path), cfg, (params, adamw_init(params)),
                                       *mesh_layout(layout), device_type="cpu")
    full = shd.assemble_tree(state, steps.state_specs(cfg, mesh), mesh)
    return {"state": as_numpy(full), "meta": meta,
            "local_shapes": [tuple(t.shape) for t in __import__(
                "repro_torch.tree", fromlist=["leaves"]).leaves(state)]}


# the tolerances of a sharded run against the one-process run
# (`tests/test_torch_mesh_step.py` says why)
F32_METRIC, F32_LEAF = 1e-5, 1e-4
BF16_METRIC, BF16_LEAF, BF16_SUMMED, BF16_MOMENTS = 2e-3, 1.5e-2, 2e-2, 2.5e-2


_ONE = {}


def one_process(arch, accum, dtype):
    """The one-process step's run of a `step:` scenario (cached)."""
    import torch
    from repro_torch.launch import steps
    from repro_torch.optim import AdamWConfig, adamw_init

    key = (arch, accum, dtype)
    if key not in _ONE:
        cfg = smoke_cfg(arch)
        p = start_params(cfg, dtype)
        o = adamw_init(p)
        step = steps.make_train_step(cfg, AdamWConfig(lr=LR), grad_accum=accum,
                                     q_block=Q_BLOCK, param_dtype=getattr(torch, dtype))
        mets = []
        for b in batches(cfg):
            p, o, met = step(p, o, to_torch(b))
            mets.append({k: float(v) for k, v in met.items()})
        _ONE[key] = {"metrics": mets, "state": as_numpy((p, o))}
    return _ONE[key]


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def check(got, want, dtype):
    """Metrics and the reassembled state of a sharded run against the
    one-process run; returns the worst leaf's (error, name)."""
    from tests.train_parity import SUMMED

    for gm, wm in zip(got["metrics"], want["metrics"]):
        for k, w in wm.items():
            tol = F32_METRIC if dtype == "float32" else BF16_METRIC
            assert abs(gm[k] - w) <= tol * max(abs(w), 1e-6), (k, gm[k], w)
    worst = (0.0, "")
    assert [n for n, _ in got["state"]] == [n for n, _ in want["state"]]
    for (name, g), (_, w) in zip(got["state"], want["state"]):
        assert g.shape == w.shape, name
        if g.dtype.kind != "f":
            assert np.array_equal(g, w), name        # the step count
            continue
        err = rel_l2(g, w)
        if dtype == "float32":
            tol = F32_LEAF
        elif name.split("/")[1] in ("m", "v"):
            tol = BF16_MOMENTS
        else:
            tol = BF16_SUMMED if name.split("/")[-1] in SUMMED else BF16_LEAF
        assert err <= tol, (name, err, tol)
        worst = max(worst, (err, name))
    return worst



def run_job(job: str):
    kind, _, arg = job.partition(":")
    if kind == "step":
        return _step_job(*arg.split(":"))
    if kind == "moe_layer":
        return _moe_layer()
    if kind == "ds_step":
        return _ds_step(arg)
    if kind == "ds_step_f32":
        return _ds_step(arg, f32=True)
    if kind == "psum_pod":
        return _psum_pod()
    if kind == "ckpt_write":
        return _ckpt_write(arg)
    if kind == "ckpt_restore":
        return _ckpt_restore(*arg.rsplit(":", 1))
    raise ValueError(job)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(world: int, path: Path, jobs, timeout: int = 600,
           module: str = "tests.mesh_worker") -> dict:
    """Run the jobs on `world` gloo ranks (`torch.distributed.run` as a
    child running `module`, one torch thread a rank, a free port from the
    OS) and load rank 0's results."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env["OMP_NUM_THREADS"] = "1"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", str(world),
           "--master-addr", "127.0.0.1", "--master-port", str(free_port()),
           "-m", module, str(path), *jobs]
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=timeout)
    if proc.returncode:
        raise RuntimeError(f"mesh worker exited {proc.returncode}:\n{proc.stderr[-6000:]}")
    with open(path, "rb") as f:
        return pickle.load(f)


def main(path, jobs):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="env://")
    out = {job: run_job(job) for job in jobs}
    if dist.get_rank() == 0:
        with open(path, "wb") as f:
            pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2:])
