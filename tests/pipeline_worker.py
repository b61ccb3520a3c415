"""The port's pipeline (`repro_torch.launch.pipeline`), run by every rank
of a gloo world for `tests/test_torch_pipeline*.py` (not a test file).

    python -m tests.pipeline_worker OUT.pkl JOB [JOB ...]   (one process per
                                                          rank, through `launch`)

Each rank runs every job in order; rank 0 pickles {job: result}.  Jobs:
  * `pp:<arch>:<S or SxDxM>:<dtype>[:<n_layers>]` -- the smoke config
    (`n_layers` layers if given) at `common.fan_in_init` of its seed-0
    draws (cast to f32 for dtype float32), on the mesh (`_mesh`): `pp_forward`'s
    logits of the first batch, then `STEPS` steps of `make_pp_train_step`
    (`MICRO` microbatches) on `tests/mesh_worker.py`'s batches, each rank
    on its rows: the logits (reassembled, f32), every step's metrics and
    the state reassembled after the last (numpy f32);
  * `jax:<in.pkl>:<job>` -- a `tests/pipeline_reference.py` job's
    scenario from the reference's parameters and batch in in.pkl, on a
    stage-only mesh of the world's size: `pp_forward`'s logits (uint16
    words) and 3 steps' losses, grad norms and parameters (numpy f32);
  * `hop` -- `parallel.stage_hop` (forward and backward) and
    `from_last_stage` on the world's stage-only mesh, on seeded per-rank
    floats;
  * `refusals` -- the refusals' messages (None where a case ran).

`one_process` runs a `pp:` scenario's one-process step.
"""

import dataclasses
import pickle
import sys

import numpy as np

from tests import mesh_worker as mw
from tests import pipeline_reference as pr

MICRO, PP_METRICS = 4, ("loss", "grad_norm", "lr")


def pp_cfg(arch: str, n_layers=None):
    from repro_torch import configs
    cfg = configs.get_arch(arch, smoke=True)
    return cfg if n_layers is None else dataclasses.replace(cfg, n_layers=int(n_layers))


def pp_layout(text: str):
    shape = tuple(int(t) for t in text.split("x"))
    return shape if len(shape) == 3 else (shape[0], 1, 1)


def _mesh(layout):
    """`S` -> a ("stage",) mesh; `SxDxM` -> ("stage", "data", "model"), 1 x
    1 x 1 too (`make_pp_mesh` makes that one ("stage",))."""
    from repro_torch.launch import mesh as mesh_lib
    if "x" not in layout:
        return mesh_lib.make_pp_mesh(int(layout), 1, 1, device_type="cpu")
    return mesh_lib.make_mesh(pp_layout(layout), ("stage", "data", "model"), device_type="cpu")


def _rows(x, mesh):
    """The global rows of a microbatch-major local tensor (`local_batch`'s
    inverse): each data rank's rows of each microbatch, in order."""
    import torch
    from repro_torch.launch.mesh import data_axes_of
    from repro_torch.models import parallel
    dp = parallel.data_size(mesh, data_axes_of(mesh))
    if dp == 1:
        return x
    parts = parallel.all_gather_dim(x, 0, mesh, "data").chunk(dp)
    per = [p.chunk(MICRO) for p in parts]
    return torch.cat([per[r][i] for i in range(MICRO) for r in range(dp)])


def _full_logits(logits, cfg, mesh):
    from repro_torch.models import lm, parallel
    if lm.vocab_offset(cfg, logits.shape[-1], mesh) is not None:
        logits = parallel.all_gather_dim(logits, logits.dim() - 1, mesh, "model")
    return _rows(logits, mesh)


def _pp_job(arch, layout, dtype, n_layers=None):
    import torch
    from repro_torch.launch import pipeline as pp, sharding as shd, steps
    from repro_torch.optim import AdamWConfig

    cfg = pp_cfg(arch, n_layers)
    mesh = _mesh(layout)
    p, o = steps.shard_train_state(mw.start_params(cfg, dtype), cfg, mesh, pp.PP_OVERRIDES)
    bs = mw.batches(cfg)
    with torch.no_grad():
        logits = pp.pp_forward(p, torch.from_numpy(steps.local_batch(bs[0], mesh, MICRO)["tokens"]),
                               cfg, mesh, MICRO, steps._run_ctx(cfg, mesh, mw.Q_BLOCK))
    step = pp.make_pp_train_step(cfg, mesh, MICRO, AdamWConfig(lr=mw.LR), q_block=mw.Q_BLOCK,
                                 param_dtype=getattr(torch, dtype))
    mets = []
    for b in bs:
        p, o, met = step(p, o, mw.to_torch(steps.local_batch(b, mesh, MICRO)))
        mets.append({k: float(v) for k, v in met.items()})
    state = shd.assemble_tree((p, o), steps.state_specs(cfg, mesh, pp.PP_OVERRIDES), mesh)
    return {"logits": _full_logits(logits, cfg, mesh).float().numpy(), "metrics": mets,
            "state": mw.as_numpy(state)}


def _jax_job(path, job):
    import torch
    from repro_torch import configs, tree as tree_lib
    from repro_torch.launch import pipeline as pp, sharding as shd, steps
    from repro_torch.models import registry

    with open(path, "rb") as f:
        inp = pickle.load(f)[job]
    arch, n_layers, stages = pr.JOBS[job.partition("@")[0]]
    cfg = pr.cfg_of(configs, arch, n_layers)
    mesh = pp.make_pp_mesh(stages, 1, 1, device_type="cpu")
    params = pr.to_port(inp["params"], registry.materialize_params(cfg, 0, device="cpu"))
    p, o = steps.shard_train_state(params, cfg, mesh, pp.PP_OVERRIDES)
    batch = mw.to_torch(inp["batch"])
    with torch.no_grad():
        logits = pp.pp_forward(p, batch["tokens"], cfg, mesh, pr.MICRO,
                               steps._run_ctx(cfg, mesh, pr.Q_BLOCK))
    step = pp.make_pp_train_step(cfg, mesh, pr.MICRO, q_block=pr.Q_BLOCK)
    losses, norms = [], []
    for _ in range(pr.STEPS):
        p, o, met = step(p, o, batch)
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
    full = shd.assemble_tree(p, pp.pp_param_pspecs(cfg, mesh), mesh)
    return {"logits": logits.view(torch.int16).numpy().view(np.uint16), "losses": losses,
            "grad_norms": norms, "params": [t.float().numpy() for t in tree_lib.leaves(full)],
            "metric_keys": sorted(met)}


def _hop():
    """Each rank's x, hop(x), the gradient of sum(hop(x) * w) for a
    per-rank w, and from_last_stage(x)."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch import pipeline as pp
    from repro_torch.models import parallel

    mesh = pp.make_pp_mesh(dist.get_world_size(), 1, 1, device_type="cpu")
    rng = np.random.default_rng(mesh.coord("stage"))
    x = torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32)).requires_grad_(True)
    w = torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32))
    y = parallel.stage_hop(x, mesh)
    (g_hop,) = torch.autograd.grad((y * w).sum(), [x])
    z = parallel.from_last_stage(x, mesh)
    mine = {k: t.detach().numpy() for k, t in
            dict(x=x, w=w, hop=y, g_hop=g_hop, last=z).items()}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, (mesh.coord("stage"), mine))
    return dict(every)


def _refusals():
    """{case: the error's message, or None where the case ran}."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch import pipeline as pp, steps
    from repro_torch.models import registry

    world = dist.get_world_size()
    mesh = pp.make_pp_mesh(world, 1, 1, device_type="cpu")
    out = {}

    def attempt(name, fn):
        try:
            fn()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)

    for arch in ("deepseek-v2-lite-16b", "deepseek-moe-16b", "mamba2-2.7b", "jamba-v0.1-52b",
                 "seamless-m4t-medium"):
        attempt(arch, lambda: pp.make_pp_train_step(pp_cfg(arch), mesh))
        attempt(f"forward:{arch}", lambda: pp.pp_forward(None, None, pp_cfg(arch), mesh, MICRO))
    cfg = pp_cfg("yi-6b", world + 1)
    attempt("groups", lambda: pp.make_pp_train_step(cfg, mesh))
    cfg = pp_cfg("yi-6b", world)
    p, o = steps.shard_train_state(registry.materialize_params(cfg, 0, device="cpu"), cfg, mesh,
                                   pp.PP_OVERRIDES)
    tokens = torch.zeros((6, 16), dtype=torch.int32)
    with torch.no_grad():
        attempt("rows", lambda: pp.pp_forward(p, tokens, cfg, mesh, MICRO))
    step = pp.make_pp_train_step(cfg, mesh, MICRO)
    attempt("step_rows", lambda: step(p, o, {"tokens": tokens, "labels": tokens}))
    p_grad = {k: v for k, v in p.items()}
    p_grad["final_norm"] = p["final_norm"].detach().requires_grad_(True)
    attempt("differentiable", lambda: pp.pp_forward(p_grad, tokens[:4], cfg, mesh, MICRO))
    if world % 2 == 0:
        dmesh = pp.make_pp_mesh(world // 2, 2, 1, device_type="cpu")
        attempt("data_rows", lambda: steps.local_batch(
            {"tokens": np.zeros((12, 16), np.int32)}, dmesh, MICRO))
    return out


def run_job(job: str):
    kind, _, arg = job.partition(":")
    if kind == "pp":
        return _pp_job(*arg.split(":"))
    if kind == "jax":
        return _jax_job(*arg.rsplit(":", 1))
    if kind == "hop":
        return _hop()
    if kind == "refusals":
        return _refusals()
    raise ValueError(job)


_ONE = {}


def one_process(arch, dtype, n_layers=None, grad_accum=1):
    """The one-process step's run of a `pp:` scenario (cached): its logits
    of the first batch (`lm.forward`, no remat), the pipeline's metrics of
    every step and the state after the last."""
    import torch
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, adamw_init

    key = (arch, dtype, n_layers, grad_accum)
    if key not in _ONE:
        cfg = pp_cfg(arch, n_layers)
        p = mw.start_params(cfg, dtype)
        bs = mw.batches(cfg)
        with torch.no_grad():
            logits = lm.forward(p, torch.from_numpy(bs[0]["tokens"]), cfg,
                                steps._run_ctx(cfg, None, mw.Q_BLOCK), remat=False).logits
        o = adamw_init(p)
        step = steps.make_train_step(cfg, AdamWConfig(lr=mw.LR), grad_accum=grad_accum,
                                     q_block=mw.Q_BLOCK, param_dtype=getattr(torch, dtype))
        mets = []
        for b in bs:
            p, o, met = step(p, o, mw.to_torch(b))
            mets.append({k: float(met[k]) for k in PP_METRICS})
        _ONE[key] = {"logits": logits.float().numpy(), "metrics": mets,
                     "state": mw.as_numpy((p, o))}
    return _ONE[key]


TIMEOUT = 300    # seconds a world may take; a rank that hangs fails the test


def launch(world, path, jobs):
    return mw.launch(world, path, jobs, TIMEOUT, module="tests.pipeline_worker")


def main(path, jobs):
    import datetime

    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="env://",
                            timeout=datetime.timedelta(seconds=TIMEOUT))
    out = {job: run_job(job) for job in jobs}
    if dist.get_rank() == 0:
        with open(path, "wb") as f:
            pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2:])
