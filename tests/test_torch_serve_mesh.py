"""Serving on a mesh (`launch.serve --mesh`, both engines on the mixed
layout) against the port's one-process engines, over gloo on the CPU.

Each world size's ranks start once (`tests/serve_mesh_worker.py`, a module
fixture, `mesh_worker.launch`) and run every scenario of that size; the
one-process runs are the same function here.  Every scenario serves 4
seeded prompts of 24 tokens (2040 for the slot split) for 12 new tokens
on the smoke config at fp_window = recompress_interval = 8 (a probe step
and a fold), lockstep and continuous:

  * world 2: yi-6b at 2 x 1 (rows) and 1 x 2 (its 2 kv heads split), and
    at 1 x 2 under tests/test_backend_conformance.py's precision map;
    smollm-360m at 1 x 2 (3 heads and 1 kv head: the cache whole on both
    model ranks); mamba2-2.7b at 1 x 2 (SSM heads and d_inner split, the
    state read whole); lockstep only, seamless-m4t-medium at 1 x 2 over
    64 source frames and llava-next-34b at 2 x 1;
  * world 4: yi-6b at 2 x 2; yi-6b at 1 x 4 with a 2052-token cache (2 kv
    heads on 4 ranks: every store, and the 128-slot window, split over
    slots: split-KV); DeepSeek-V2-Lite at 2 x 2 (the MLA cache whole on
    the model ranks, the experts split over `model` with the reference's
    bf16 sum, at `mesh_worker.smoke_cfg`'s no-drop capacity).

The contract (ROADMAP.md §3, departures):

  * the cache assembled from the ranks' blocks after the lockstep prefill
    bitwise the one-process cache's (the prefill gathers its weights and
    computes whole), and after every fold its positions and counters;
  * where the mesh has one model rank (rows over data) the tokens, the
    logits and every later cache leaf bitwise too;
  * where it has more, the decode step computes the heads, the MLP width
    and the vocabulary on each rank's block (the row-parallel products
    summed over `model` in f32), a slot split merges its partial
    softmaxes, the experts sum in bf16: float sums in another order.  The
    logits of the prefill and of every step are within LOGIT_TOL of the
    row's largest, the tokens equal up to the first step at which the
    one-process logits of that row have their top two within NEAR_TIE
    (relative): a near tie; a folded cache's float leaves within
    CACHE_RTOL / CACHE_ATOL, and at most CODE_SHARE of its code bytes
    differ (a value an ulp off crosses a quantization boundary).  Readings
    on the CPU: yi-6b 1 x 2 and 2 x 2 logits 1.21e-2, under the precision
    map 1.43e-2; cache floats within rtol 6.2e-3 at atol 1e-3; 2 of 6400
    code bytes of a snapshot (3.1e-4); every other scenario bitwise; every
    token equal;
  * each rank's `cache_bytes` is its block's: the one-process leaves'
    bytes over each leaf's split (a model rank holds 1/m of the stores'
    codes under either split, a data rank its rows), and
    `mesh_total_bytes` their sum.

Plus `python -m torch.distributed.run --nproc-per-node 2 -m
repro_torch.launch.serve --mesh 1x2 --device cpu --smoke` printing the
one-process CLI's tokens.
"""

import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests import mesh_worker as mw
from tests import serve_mesh_worker as sw
from tests.torch_parity import torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")

ENGINES = ("lockstep", "continuous")
WORLD2 = [("yi-6b", "2x1", 24), ("yi-6b", "1x2", 24), ("smollm-360m", "1x2", 24),
          ("mamba2-2.7b", "1x2", 24), ("yi-6b+map", "1x2", 24)]
LOCKSTEP2 = [("seamless-m4t-medium", "1x2", 64), ("llava-next-34b", "2x1", 64)]
WORLD4 = [("yi-6b", "2x2", 24), ("yi-6b", "1x4", 2040), ("deepseek-v2-lite-16b", "2x2", 24)]
MAX_NEW, BATCH = 12, 4
LOGIT_TOL = 2e-2       # of the row's largest |logit| (reading 1.43e-2)
CACHE_RTOL, CACHE_ATOL = 1e-2, 1e-3     # a folded cache's floats (reading: rtol 6.2e-3)
CODE_SHARE = 1e-3      # of a folded cache's code bytes that may differ (reading 3.1e-4)
NEAR_TIE = 1e-2        # top-2 gap over |top-1| of the one-process logits


def _job(case, engine):
    arch, layout, prompt = case
    return f"serve:{arch}:{layout}:{engine}:{prompt}:{MAX_NEW}:{BATCH}"


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return mw.launch(2, tmp_path_factory.mktemp("serve2") / "out.pkl",
                     [_job(c, e) for c in WORLD2 for e in ENGINES]
                     + [_job(c, "lockstep") for c in LOCKSTEP2],
                     module="tests.serve_mesh_worker")


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return mw.launch(4, tmp_path_factory.mktemp("serve4") / "out.pkl",
                     [_job(c, e) for c in WORLD4 for e in ENGINES],
                     module="tests.serve_mesh_worker")


def near_tie_steps(logits_steps, n_rows: int) -> list:
    """Per row, the first step whose logits have their top two within
    NEAR_TIE of the top one (len(steps) where none does)."""
    first = [len(logits_steps)] * n_rows
    for i, lg in enumerate(logits_steps):
        top = torch.topk(lg.float(), 2, dim=-1).values
        tie = (top[:, 0] - top[:, 1]) <= NEAR_TIE * top[:, 0].abs()
        for r in range(min(n_rows, lg.shape[0])):
            if tie[r] and first[r] == len(logits_steps):
                first[r] = i
    return first


def check_tokens_and_logits(got, want, bitwise: bool):
    """The contract's token and logit rules (module docstring); returns the
    near-tie steps of the one-process run."""
    assert len(got["logits"]) == len(want["logits"])
    ties = near_tie_steps(want["logits"], len(want["tokens"]))
    if bitwise:
        assert got["tokens"] == want["tokens"]
        for a, b in zip(got["logits"], want["logits"]):
            assert torch.equal(a, b)
        return ties
    for r, (gt, wt) in enumerate(zip(got["tokens"], want["tokens"])):
        n = min(len(gt), len(wt), ties[r])
        assert gt[:n] == wt[:n], (r, ties[r])
    for a, b in zip(got["logits"], want["logits"]):
        err = (a - b).abs().amax(dim=-1) / b.abs().amax(dim=-1)
        assert float(err.max()) <= LOGIT_TOL
    return ties


def check_caches(got, want, bitwise: bool, prefilled: bool):
    """The prefill's snapshot (the first, where `prefilled`: the lockstep
    engine) bitwise; each fold's as the contract says."""
    assert len(got["caches"]) == len(want["caches"]) > 0
    for i, (snap_g, snap_w) in enumerate(zip(got["caches"], want["caches"])):
        codes = differ = 0
        for el_g, el_w in zip(snap_g, snap_w):
            for a, b in zip(el_g, el_w):
                assert a.shape == b.shape and a.dtype == b.dtype
                code = a.dtype in (torch.int8, torch.uint8)
                if bitwise or (prefilled and i == 0) or not (code or a.is_floating_point()):
                    assert torch.equal(a, b)
                elif a.is_floating_point():
                    assert torch.allclose(a.float(), b.float(), rtol=CACHE_RTOL,
                                          atol=CACHE_ATOL)
                else:
                    codes += a.numel()
                    differ += int((a != b).sum())
        assert differ <= CODE_SHARE * codes


def check_bytes(got, want, layout: str):
    """Every rank's bytes are its block of the one-process leaves."""
    shape, axes = mw.mesh_layout(layout)
    size = dict(zip(axes, shape))

    def split(spec) -> int:
        n = 1
        for part in spec:
            for a in ((part,) if isinstance(part, str) else part or ()):
                n *= size[a]
        return n

    expect = sum(b // split(s) for el_b, el_s in zip(want["leaf_bytes"], got["specs"])
                 for b, s in zip(el_b, el_s))
    totals = [r["total_bytes"] for r in got["bytes"]]
    assert totals == [expect] * math.prod(shape)
    assert all(r["mesh_total_bytes"] == sum(totals) for r in got["bytes"])
    assert sum(r["packed_bytes"] for r in got["bytes"]) >= want["bytes"]["packed_bytes"]


def _check(results, case, engine):
    arch, layout, prompt = case
    got = results[_job(case, engine)]
    want = sw.scenario(arch, "none", engine, prompt, MAX_NEW, BATCH)
    bitwise = mw.mesh_layout(layout)[0][-1] == 1      # one model rank
    check_tokens_and_logits(got, want, bitwise)
    check_caches(got, want, bitwise, prefilled=engine == "lockstep")
    check_bytes(got, want, layout)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("case", WORLD2, ids=lambda c: f"{c[0]}-{c[1]}")
def test_serving_matches_one_process_world2(world2, case, engine):
    _check(world2, case, engine)


@pytest.mark.parametrize("case", LOCKSTEP2, ids=lambda c: f"{c[0]}-{c[1]}")
def test_lockstep_frontends_match_one_process_world2(world2, case):
    """The encoder-decoder (its cross caches split as its self caches) and
    a frontend arch (the embeddings' rows over data) on the lockstep engine
    (the continuous engine refuses both, as the reference's)."""
    _check(world2, case, "lockstep")


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("case", WORLD4, ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}")
def test_serving_matches_one_process_world4(world4, case, engine):
    _check(world4, case, engine)


def test_slot_split_holds_a_block_of_every_store(world4):
    """The 1 x 4 scenario's specs split the stores' slots (and the 128-slot
    window), never the 2 kv heads; the channelwise K scales stay whole."""
    specs = world4[_job(WORLD4[1], "lockstep")]["specs"][0]
    assert all(s[1] is None for s in specs if len(s) == 4)
    assert sum(s[2] == "model" for s in specs if len(s) == 4) >= 8
    assert any(len(s) == 4 and "model" not in s for s in specs)


def _serve_cli_mesh(args):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(mw.ROOT / "src"), str(mw.ROOT)]),
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
         "--master-addr", "127.0.0.1", "--master-port", str(mw.free_port()),
         "-m", "repro_torch.launch.serve", "--mesh", "1x2"] + args,
        cwd=mw.ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout


def _token_lines(out: str) -> list:
    """The printed tokens: the lockstep's first request, each continuous
    request's `first=` list."""
    return [ln.split(" first=")[-1] if " first=" in ln else ln for ln in out.splitlines()
            if "tokens" in ln or " first=" in ln]


def test_serve_cli_mesh_prints_the_one_process_tokens(capsys):
    from repro_torch.launch import serve
    args = ["--arch", "yi-6b", "--smoke", "--device", "cpu", "--batch", "2", "--prompt-len",
            "24", "--max-new", "12"]
    mesh = _serve_cli_mesh(args)
    capsys.readouterr()
    serve.main(args)
    one = capsys.readouterr().out
    assert _token_lines(mesh) == _token_lines(one) and _token_lines(one)
    assert mesh.count("[serve] device:") == 1          # rank 0 alone printed


def test_near_tie_rule_reads_the_gap():
    lg = [torch.tensor([[1.0, 0.995, 0.0], [1.0, 0.5, 0.0]]),
          torch.tensor([[1.0, 0.5, 0.0], [1.0, 0.999, 0.0]])]
    assert near_tie_steps(lg, 2) == [0, 1]
    assert near_tie_steps(lg[1:], 2) == [1, 0]
    assert np.isclose(NEAR_TIE, 1e-2)
