"""Serving on a mesh against the JAX package's, on a 4 x 2 ("data",
"model") mesh: the reference jitted on 8 fake CPU devices in one child
process (`tests/mesh_reference.py`: excess precision and the algebraic
simplifier off, a persistent compilation cache), the port over 8 gloo
ranks (`tests/serve_mesh_worker.py`), both at once, from the JAX
package's parameters (`mesh_reference.serve_params`).

GSPMD sums the reference's split products in another order than one
process does, so its own mesh run does not give its one-process tokens:
on yi-6b smoke (zipcache at fp_window = recompress_interval = 8, batch 4,
24-token prompts, 12 new tokens) rows 1-3 equal its `mesh=None` run and
row 0 parts at new token 9 with these flags.
Its logits leave the one process's from the prefill on (2.05e-2 of the
largest there, up to 1.59 of a 2.48 logit in row 0 by step 7: far more
than a last bit).  So the port is held
to the reference's mesh at the near-tie rule of
`tests/test_torch_serve_mesh.py` widened by that drift: the reference's
prefill logits within REF_TOL of the port's one-process logits (bitwise
the JAX package's one-process run, ROADMAP parity contract (c)), and the
port's 4 x 2 tokens equal the reference's up to the first step at which
the one-process logits of that row have their top two within NEAR_TIE,
or within twice the reference's own drift at that step.  The port's mesh
run itself (its decode computing heads, MLP width and vocabulary on each
rank's block, the row-parallel products summed over `model` in f32)
equals its one-process run: the tokens, and the logits within LOGIT_TOL
(reading 6.45e-3, at one step).  Readings: the tokens equal the
reference's in rows 1-3 and through step 8 in row 0.

DeepSeek-V2-Lite: `tests/test_sharding.py`'s decode step (batch 8 of a
128-token decode shape over empty caches, tokens 0, a probe step) on
both meshes: the logits within LOGIT_TOL of each row's largest (reading
1.68e-2) and the same greedy tokens (the experts' bf16 sums over `model`
are the reference's on both sides).
"""

import pickle
import threading

import numpy as np
import pytest
import torch

from tests import mesh_reference as mr
from tests import mesh_worker as mw
from tests import serve_mesh_worker as sw
from tests.test_torch_serve_mesh import LOGIT_TOL, near_tie_steps
from tests.torch_parity import torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")

REF_TOL = 5e-2      # the reference mesh's prefill logits against one process's


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"jax": the reference's jobs, "port": the port's 4 x 2 jobs, "params":
    the pickle both read}, the child and the 8 ranks run at once."""
    d = tmp_path_factory.mktemp("serve_jax")
    params = d / "params.pkl"
    with open(params, "wb") as f:
        pickle.dump({a: mr.serve_params(a) for a in ("yi-6b", "deepseek-v2-lite-16b")}, f)
    out = {"params": str(params)}

    def reference():
        out["jax"] = mr.run(d / "ref.pkl", ["serve_yi", "serve_ds"])

    child = threading.Thread(target=reference)
    child.start()
    try:
        out["port"] = mw.launch(8, d / "port.pkl", [f"jax_yi:{params}:4x2", f"jax_ds:{params}:4x2"],
                                module="tests.serve_mesh_worker")
    finally:
        child.join()
    return out


def drift_ties(ref_logits, one_logits) -> list:
    """Per row, the first step at which the reference mesh's own drift
    reaches the one-process top-2 gap: |ref - one| (the row's largest)
    at least half of (top-1 - top-2) of the one-process logits."""
    n_steps, n_rows = one_logits.shape[:2]
    first = [n_steps] * n_rows
    for i in range(n_steps):
        top = np.sort(one_logits[i], axis=-1)[:, ::-1]
        drift = np.abs(ref_logits[i] - one_logits[i]).max(-1)
        for r in range(n_rows):
            if top[r, 0] - top[r, 1] <= 2 * drift[r] and first[r] == n_steps:
                first[r] = i
    return first


def test_yi_lockstep_against_the_reference_mesh(runs):
    got = runs["port"][f"jax_yi:{runs['params']}:4x2"]
    one = sw.jax_yi(runs["params"], "none")
    ref = runs["jax"]["serve_yi"]
    tokens = got["tokens"].tolist()
    # the port's mesh: its one-process run
    assert tokens == one["tokens"].tolist()
    err = np.abs(got["logits"] - one["logits"]).max(-1) / np.abs(one["logits"]).max(-1)
    assert err.max() <= LOGIT_TOL
    # the reference's mesh: its prefill within REF_TOL of the one process,
    # then its tokens up to its own drift's first near tie in each row
    pre = np.abs(ref["logits"][0] - one["logits"][0]).max(-1) / np.abs(one["logits"][0]).max(-1)
    assert pre.max() <= REF_TOL
    ties = [min(a, b) for a, b in zip(
        near_tie_steps([torch.from_numpy(x) for x in one["logits"]], len(tokens)),
        drift_ties(ref["logits"], one["logits"]))]
    for r, (mine, theirs) in enumerate(zip(tokens, ref["tokens"].tolist())):
        assert mine[:ties[r]] == theirs[:ties[r]], (r, ties[r])


def test_deepseek_decode_step_against_the_reference_mesh(runs):
    got = torch.from_numpy(runs["port"][f"jax_ds:{runs['params']}:4x2"])
    ref = torch.from_numpy(runs["jax"]["serve_ds"]["logits"])
    err = (got - ref).abs().amax(dim=-1) / ref.abs().amax(dim=-1)
    assert float(err.max()) <= LOGIT_TOL
    assert torch.equal(got.argmax(-1), ref.argmax(-1))
