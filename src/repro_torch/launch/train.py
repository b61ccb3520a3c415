"""Training driver of the port (port of `repro.launch.train`): --arch <id>
end-to-end fault-tolerant training on one card or on a mesh.

The reference's flags, plus `--device` (default `cuda`; `--device cpu` runs
on the CPU).  `--mesh`: `1x1` (the default) trains on one device with no
mesh, as the reference's; `DxM` on a ("data", "model") mesh of D x M
processes; `single` and `multi` on the production meshes (16 x 16 and 2 x
16 x 16 with `pod`).  A mesh's size must be torchrun's WORLD_SIZE; the
processes talk over NCCL for `--device cuda` (each on cuda:LOCAL_RANK) and
gloo for `--device cpu`.  Every rank builds the global batch from the
pipeline and takes its rows (`steps.local_batch`), and rank 0 alone prints
and writes the checkpoints (the full logical leaves, which restore on any
mesh).  Every arch of the registry trains: the dense decoder, MoE (with
its aux loss), MLA, the SSD and hybrid layers, the encoder-decoder (the
pipeline's f32 source frames under its tokens) and the frontend archs (the
pipeline's frontend embeddings before the text, the loss over the text).
The step donates its state, as the reference's CLI jits it with donated
buffers: one training state is live.  Each step's metrics reach the host
once, as one stacked transfer.

Example (CPU smoke):
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m --smoke \\
      --device cpu --steps 20 --batch 4 --seq-len 32
On the card (smollm-360m at full size; any other `--arch` likewise):
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      --steps 100 --batch 8 --seq-len 2048
On a mesh, over gloo on the CPU (2 processes, data 2 x model 1):
  PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 2 \\
      -m repro_torch.launch.train --device cpu --mesh 2x1 --arch smollm-360m --smoke \\
      --steps 20 --batch 4 --seq-len 32
and over NCCL on 8 cards of one host (data 4 x model 2):
  PYTHONPATH=src torchrun --nproc-per-node 8 -m repro_torch.launch.train \\
      --mesh 4x2 --arch deepseek-v2-lite-16b --steps 100 --batch 16 --seq-len 4096
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch import configs
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import serve
from repro_torch.launch import steps as steps_lib
from repro_torch.models import registry
from repro_torch.optim import AdamWConfig, adamw_init, cosine_schedule
from repro_torch.runtime import FaultTolerantLoop, PreemptionGuard, StragglerDetector


def build(args, mesh=None):
    cfg = configs.get_arch(args.arch, smoke=args.smoke)
    shape = ShapeConfig("train", args.seq_len, args.batch, "train")
    opt_cfg = AdamWConfig(lr=args.lr, schedule=cosine_schedule(args.warmup, args.steps))
    accum = args.grad_accum or steps_lib.pick_grad_accum(cfg, shape, mesh)
    train_step = steps_lib.make_train_step(
        cfg, opt_cfg, grad_accum=accum, q_block=min(512, args.seq_len), mesh=mesh)
    return cfg, train_step, accum


def data_config(cfg, seq_len: int, batch: int, seed: int) -> DataConfig:
    """The pipeline's config for `cfg`, as the reference's CLI builds it: a
    frontend arch's batches carry its frontend embeddings before a shorter
    text, the encoder-decoder's its f32 source frames."""
    return DataConfig(seq_len=seq_len, global_batch=batch, vocab=cfg.vocab, seed=seed,
                      frontend_tokens=cfg.n_frontend_tokens if cfg.frontend != "none" else 0,
                      d_model=cfg.d_model, encdec=cfg.encdec)


def to_device(batch, device) -> dict:
    """A host batch of numpy arrays as device tensors (blocking copies: the
    pipeline never reuses a handed-out array, and nothing here writes it)."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def make_step_fn(train_step, device, profile_step: int = 0, rows=None):
    """(state, host batch) -> (state, {name: float}): one host transfer of
    every metric per step.  profile_step: the call (1-based) that runs
    under torch.profiler (0: none), which prints device time by kernel.
    rows: on a mesh, the global batch -> this rank's rows."""
    calls = [0]

    def step_fn(state, batch):
        calls[0] += 1
        if calls[0] == profile_step:
            def timed():
                t0 = time.perf_counter()
                return run(state, batch), time.perf_counter() - t0
            return serve.profiled(timed, device, "train")
        return run(state, batch)

    def run(state, batch):
        params, opt_state = state
        if rows is not None:
            batch = rows(batch)
        params, opt_state, metrics = train_step(params, opt_state, to_device(batch, device))
        keys = sorted(metrics)
        vals = torch.stack([metrics[k].float().reshape(()) for k in keys]).tolist()
        return (params, opt_state), dict(zip(keys, vals))

    return step_fn


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--mesh", default="1x1")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--grad-accum", type=int, default=0)
    ap.add_argument("--checkpoint-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fail-at", type=int, default=None)  # failure injection
    ap.add_argument("--profile-step", type=int, default=0,
                    help="run this invocation's n-th step (1-based) under torch.profiler and "
                         "print device time by kernel (0: off)")
    args = ap.parse_args(argv)

    import torch.distributed as dist
    owns_group = args.mesh != "1x1" and not dist.is_initialized()
    mesh = mesh_lib.mesh_of_flag(args.mesh, "cuda" if args.device.startswith("cuda") else "cpu")
    device = torch.device(args.device)
    if mesh is not None and device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    lead = mesh is None or dist.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)
    cfg, train_step, accum = build(args, mesh)
    params = registry.materialize_params(cfg, args.seed, device=device)
    if mesh is None:
        opt_state, specs = adamw_init(params), None
    else:
        params, opt_state = steps_lib.shard_train_state(params, cfg, mesh)
        specs = steps_lib.state_specs(cfg, mesh)

    dcfg = data_config(cfg, args.seq_len, args.batch, args.seed)

    ckpt = Checkpointer(args.checkpoint_dir, keep=3, mesh=mesh, specs=specs)
    guard = PreemptionGuard()
    rows = None if mesh is None else (lambda b: steps_lib.local_batch(b, mesh, accum))
    loop = FaultTolerantLoop(
        make_step_fn(train_step, device, args.profile_step, rows), ckpt,
        checkpoint_every=args.checkpoint_every,
        max_steps=args.steps,
        straggler=StragglerDetector(),
        on_straggler=lambda ev: say(f"[straggler] {ev}"),
        fail_at_step=args.fail_at,
        preemption_guard=guard,
    )
    state, start_step, data_state = loop.resume_or((params, opt_state))
    del params, opt_state   # a restored state is a new tree: the first one is not kept
    pipe = (TokenPipeline.restore(dcfg, data_state) if data_state
            else TokenPipeline(dcfg, start_step=start_step))
    say(f"[train] {args.arch} start_step={start_step} "
        f"mesh={'none' if mesh is None else mesh.shape} device={device}")

    t0 = time.time()
    try:
        state, last, hist = loop.run(state, pipe, start_step,
                                     metrics_cb=_print_metrics if lead else None)
    finally:
        pipe.close()
        guard.restore()
        ckpt.wait()   # an in-flight save lands before the process goes on or exits
        if owns_group:
            dist.destroy_process_group()
    say(f"[train] done at step {last} in {time.time()-t0:.1f}s; "
        f"final loss={hist[-1]['loss']:.4f}" if hist else "[train] no steps run")
    return state


def _print_metrics(step, m):
    if step % 10 == 0 or step <= 3:
        print(f"  step {step:5d} loss={m['loss']:.4f} gnorm={m['grad_norm']:.3f}")


if __name__ == "__main__":
    main()
