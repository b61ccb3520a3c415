"""HTTP/SSE serving driver of the port: the network-facing twin of
`launch.serve` (a port of `repro.launch.serve_http`).

Example (on a CUDA card)::

  PYTHONPATH=src python -m repro_torch.launch.serve_http --arch yi-6b --smoke \
      --batch 2 --prompt-len 48 --max-new 16 --port 8080

Then, from any HTTP client::

  curl -N -X POST http://127.0.0.1:8080/v1/generate \
      -d '{"tokens": [12, 7, 93], "max_new_tokens": 8}'

streams one SSE ``data: {"token": ..., "index": ...}`` event per decoded
token (the concatenation is the engine's `result(rid).tokens`), and hanging
up the connection cancels the request: its slot and pages come back at
once (`GET /v1/stats` shows the pools).

Engine flags are `launch.serve`'s, shared through `serve.add_engine_args`.
The HTTP front always drives the continuous engine, so the flags gated on
`--continuous` there are valid here.  `--replicas N` runs N engine replicas
behind the least-loaded `serving.router.EngineRouter` (session affinity via
the request's ``"session"`` field): the parameters are made once on the
device and read by every replica, and each replica owns its slots, page
pools and captured decode steps.  `--device` is `cuda` by default; `--device
cpu` runs the kernels' plain versions.

SIGINT or SIGTERM stops the server: it drains every accepted request, prints
the kernel launches of the run and exits 0.
"""

from __future__ import annotations

import argparse
import asyncio
import signal

import torch

from repro_torch import configs
from repro_torch.launch import serve as serve_cli
from repro_torch.models import registry
from repro_torch.serving import ContinuousEngine, EngineRouter
from repro_torch.serving.http import HttpFrontend


def build_frontend(args) -> HttpFrontend:
    """Engine replica(s) + router + HTTP front from parsed args (the test
    seam: tests build the front without the signal handling of `serve`)."""
    device = torch.device(args.device)
    cfg = configs.get_arch(args.arch, smoke=args.smoke)
    ccfg = serve_cli.build_compression_config(args)
    scfg = serve_cli.build_serve_config(args)
    params = registry.materialize_params(cfg, seed=args.seed, device=device)
    replicas = [ContinuousEngine(cfg, ccfg, scfg, params, device=device)
                for _ in range(args.replicas)]
    engine = replicas[0] if args.replicas == 1 else EngineRouter(replicas)
    return HttpFrontend(engine, host=args.host, port=args.port)


async def serve(args) -> None:
    front = build_frontend(args)
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    for k in serve_cli.KERNELS.values():
        k.launches = 0
    await front.start()
    print(f"[serve_http] listening on http://{front.host}:{front.port} "
          f"({args.replicas} replica(s), arch={args.arch}, device: "
          f"{serve_cli.card_name(torch.device(args.device))})", flush=True)
    try:
        await stop.wait()
    finally:
        await front.stop()
    print("[serve_http] kernel launches:",
          {n: k.launches for n, k in serve_cli.KERNELS.items()}, flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    serve_cli.add_engine_args(ap)
    ap.add_argument("--host", default="127.0.0.1",
                    help="bind address for the HTTP server")
    ap.add_argument("--port", type=int, default=8080,
                    help="TCP port (0 = pick a free one and print it)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="engine replicas behind the least-loaded router; each owns its "
                         "own slots, page pools and captured steps")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    # the HTTP front always drives the continuous engine
    serve_cli.validate_engine_args(args, ap, continuous=True)
    if args.replicas < 1:
        ap.error("--replicas must be >= 1")
    asyncio.run(serve(args))


if __name__ == "__main__":
    main()
