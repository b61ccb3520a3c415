"""The port's serving on a mesh, run by every rank of a gloo world for
`tests/test_torch_serve_mesh*.py` (not a test file).

    python -m tests.serve_mesh_worker OUT.pkl JOB [JOB ...]   (one process
                                                             per rank)

Each rank runs every job in order; rank 0 pickles {job: result}.  Jobs:
  * `serve:<arch>:<DxM>:<engine>:<prompt_len>:<max_new>:<batch>`:
    `scenario` on the mesh, engine "lockstep" or "continuous";
  * `jax_yi:<params.pkl>:<DxM>` and `jax_ds:<params.pkl>:<DxM>`: the JAX
    package's mesh scenarios (`tests/mesh_reference.py`'s `serve_yi`,
    `serve_ds`) on the port, from the JAX package's parameters.
The same functions with layout "none" are the one-process runs the tests
hold them to.
"""

import dataclasses
import os
import pickle
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from tests import mesh_worker as mw  # noqa: E402

FP_WINDOW = RECOMPRESS = 8       # ROADMAP's parity contract (c)
PRECISION_MAP = "default=k8v8;layer:1-=k3v3"   # tests/test_backend_conformance.py's


def ccfg():
    from repro_torch.core.policy import CompressionConfig
    return dataclasses.replace(CompressionConfig.zipcache(), fp_window=FP_WINDOW,
                               recompress_interval=RECOMPRESS)


def prompts(cfg, prompt_len: int, batch: int):
    rng = np.random.default_rng(0)
    return [rng.integers(2, cfg.vocab, (prompt_len,)).astype(np.int32) for _ in range(batch)]


def assembled(caches, ctx):
    """The whole cache tree from every rank's block: each element gathered
    over `model` (`ShardedBackend.whole`), then its rows over the data
    axes; CPU tensors in `kvcache.tree_leaves` order per element."""
    from repro_torch.core import kvcache as kvc
    from repro_torch.launch import sharding as shd
    from repro_torch.models import registry
    out = []
    for el in registry.cache_elements(caches):
        if ctx.mesh is not None:
            el = ctx.backend.whole(el)
            el = kvc.tree_map(lambda t: shd.assemble(t, (ctx.data_axes,), ctx.mesh), el)
        out.append([t.detach().cpu().clone() for t in kvc.tree_leaves(el)])
    return out


def scenario(arch: str, layout: str, engine: str, prompt_len: int, max_new: int, batch: int):
    """yi-6b-style serving of `batch` seeded prompts on the smoke config
    (`mesh_worker.smoke_cfg`: an MoE at a capacity where no pair drops;
    `<arch>+map` under PRECISION_MAP; the encoder-decoder and the frontend
    archs with seeded f32 frontend embeddings, packed as `launch.serve`
    packs them):
    {tokens, logits (prefill (the admissions'), then every decode step,
    f32 of every row: token i of a row comes from its logits of step i),
    caches (assembled after a lockstep prefill and after every fold), bytes
    (`cache_bytes` of the final caches: every rank's of its block),
    leaf_bytes (this rank's, per element and leaf) and, on a mesh, specs
    (per element and leaf)}."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import kvcache as kvc
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import sharding as shd
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import registry
    from repro_torch.serving.engine import (ContinuousEngine, Request, ServeConfig,
                                            ServingEngine, pack_requests)

    arch, _, variant = arch.partition("+")
    cfg = mw.smoke_cfg(arch)
    mesh = None
    if layout != "none":
        shape, axes = mw.mesh_layout(layout)
        mesh = mesh_lib.make_mesh(shape, axes, device_type="cpu")
    scfg = ServeConfig(batch_size=batch, prompt_len=prompt_len, max_new_tokens=max_new,
                       precision_map=PRECISION_MAP if variant == "map" else "")
    params = registry.materialize_params(cfg, 0, device="cpu")
    cls = ServingEngine if engine == "lockstep" else ContinuousEngine
    eng = cls(cfg, ccfg(), scfg, params, device="cpu", mesh=mesh)
    ctx = eng.ctx
    rec = {"logits": [], "caches": []}

    decode, prefill = registry.decode_step, registry.prefill

    def decode_rec(*a, **k):
        logits, caches = decode(*a, **k)
        rec["logits"].append(steps_lib.gather_rows(logits, ctx).float().clone())
        return logits, caches

    def prefill_rec(params, batch_, cfg_, ctx_):
        logits, caches = prefill(params, batch_, cfg_, ctx_)
        whole = batch_["tokens"].shape[0] == 1 and engine == "continuous"
        rec["logits"].append((logits if whole else steps_lib.gather_rows(logits, ctx))
                             .float().clone())
        if not whole:
            rec["caches"].append(assembled(caches, ctx))
        return logits, caches

    registry.decode_step, registry.prefill = decode_rec, prefill_rec
    try:
        ps = prompts(cfg, prompt_len, batch)
        if engine == "lockstep":
            fold = eng._recompress

            def fold_rec(caches):
                out = fold(caches)
                rec["caches"].append(assembled(out, ctx))
                return out

            eng._recompress = fold_rec
            inputs = {"tokens": pack_requests(ps, batch, prompt_len)}
            if cfg.encdec or cfg.frontend != "none":
                n = prompt_len if cfg.encdec else cfg.n_frontend_tokens
                inputs["frontend_embeds"] = np.random.default_rng(1).standard_normal(
                    (batch, n, cfg.d_model)).astype(np.float32)
                text = (registry.prefill_lengths(cfg, eng._shape)[0] if cfg.encdec
                        else prompt_len - n)
                inputs["tokens"] = inputs["tokens"][:, :text]
            out = eng.generate(inputs)
            tokens = out["tokens"].tolist()
            final = eng.last_caches
        else:
            fold = eng._fold

            def fold_rec(due):
                freed = fold(due)
                rec["caches"].append(assembled(eng.caches, ctx))
                return freed

            eng._fold = fold_rec
            rids = [eng.submit(Request(tokens=p)) for p in ps]
            eng.run()
            tokens = [eng.result(r).tokens.tolist() for r in rids]
            final = eng.caches
            # every request is admitted at the first step, into its own slot:
            # the admissions' logits make the first step's rows
            rec["logits"] = [torch.cat(rec["logits"][:batch])] + rec["logits"][batch:]
    finally:
        registry.decode_step, registry.prefill = decode, prefill
    rec["tokens"] = tokens
    rec["bytes"] = eng.cache_bytes(final)
    els = registry.cache_elements(final)
    rec["leaf_bytes"] = [[t.numel() * t.element_size() for t in kvc.tree_leaves(el)]
                         for el in els]
    if mesh is not None:
        rec["specs"] = [[s for _, s in shd.cache_leaf_specs(el, ctx.backend.specs_of(el))]
                        for el in els]
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, rec["bytes"])
        rec["bytes"] = every
    return rec


def jax_params(path: str, arch: str):
    """The JAX package's parameters for `arch` (`mesh_reference.serve_params`,
    pickled by the test) as a port tree on the CPU."""
    import ml_dtypes

    from repro_torch import configs, convert

    with open(path, "rb") as f:
        words = pickle.load(f)[arch]

    def back(x):
        return x.view(ml_dtypes.bfloat16) if x.dtype == np.uint16 else x

    def walk(node):
        return {k: walk(v) for k, v in node.items()} if isinstance(node, dict) else back(node)

    return convert.from_jax_params(walk(words), configs.get_arch(arch, smoke=True),
                                   device="cpu")


def jax_yi(path: str, layout: str):
    """`mesh_reference._serve_yi`'s scenario on the port from the JAX
    package's parameters: {tokens, logits (prefill, then every step)}."""
    import torch
    from repro_torch import configs
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import registry
    from repro_torch.serving.engine import ServeConfig, ServingEngine, pack_requests
    from tests import mesh_reference as mr

    cfg = configs.get_arch("yi-6b", smoke=True)
    mesh = None
    if layout != "none":
        mesh = mesh_lib.make_mesh(*mw.mesh_layout(layout), device_type="cpu")
    scfg = ServeConfig(batch_size=mr.SERVE_B, prompt_len=mr.SERVE_PROMPT,
                       max_new_tokens=mr.SERVE_NEW)
    eng = ServingEngine(cfg, ccfg(), scfg, jax_params(path, "yi-6b"), device="cpu", mesh=mesh)
    logits = []
    decode, prefill = registry.decode_step, registry.prefill

    def rec(fn):
        def run(*a, **k):
            out = fn(*a, **k)
            logits.append(steps_lib.gather_rows(out[0], eng.ctx).float().clone())
            return out
        return run

    registry.decode_step, registry.prefill = rec(decode), rec(prefill)
    try:
        ps = prompts(cfg, mr.SERVE_PROMPT, mr.SERVE_B)
        tokens = eng.generate({"tokens": pack_requests(ps, mr.SERVE_B, mr.SERVE_PROMPT)})
    finally:
        registry.decode_step, registry.prefill = decode, prefill
    return {"tokens": tokens["tokens"], "logits": torch.stack(logits).numpy()}


def jax_ds(path: str, layout: str):
    """`tests/test_sharding.py`'s decode step on the port: DeepSeek-V2-Lite
    smoke from the JAX package's parameters, batch 8 over empty caches of a
    128-token shape, tokens 0, a probe step: the logits (f32)."""
    import torch
    from repro_torch import configs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.policy import CompressionConfig
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import registry

    cfg = configs.get_arch("deepseek-v2-lite-16b", smoke=True)
    mesh = None
    if layout != "none":
        mesh = mesh_lib.make_mesh(*mw.mesh_layout(layout), device_type="cpu")
    step, ctx = steps_lib.make_serve_step(cfg, ShapeConfig("d", 128, 8, "decode"),
                                          CompressionConfig.zipcache(), q_block=32, device="cpu",
                                          capture=False, mesh=mesh)
    params = jax_params(path, "deepseek-v2-lite-16b")
    if mesh is not None:
        from repro_torch.launch import sharding as shd
        params = shd.shard_serve_params(params, cfg, mesh)
    with torch.inference_mode():
        caches = registry.init_caches(cfg, ctx, 8, device="cpu")
        rows = steps_lib.local_rows(ctx) or (0, 8)
        tok = torch.zeros((rows[1] - rows[0],), dtype=torch.int32)
        logits, _ = step(params, caches, tok, True)
        return steps_lib.gather_rows(logits, ctx).float().numpy()


def run_job(job: str):
    kind, _, arg = job.partition(":")
    if kind == "serve":
        arch, layout, engine, pl, mn, b = arg.split(":")
        return scenario(arch, layout, engine, int(pl), int(mn), int(b))
    if kind == "jax_yi":
        return jax_yi(*arg.rsplit(":", 1))
    if kind == "jax_ds":
        return jax_ds(*arg.rsplit(":", 1))
    raise ValueError(job)


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
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    main(sys.argv[1], sys.argv[2:])
