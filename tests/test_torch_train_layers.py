"""Each new layer of the port under autograd against the JAX package's, on
the CPU: the VJP of the layer fed the reference's own parameters and
inputs and a seeded cotangent per output (`tests/train_reference.py`'s
`vjp:<layer>` jobs, `jax.vjp` op by op in a child process with excess
precision and the algebraic simplifier off), at `common.fan_in_init` of
the reference's draws of each smoke config:

  * `mlp.moe_ffn` (DeepSeek-V2-Lite's first MoE layer; outputs y and the
    aux loss, so the router takes the aux's gradient through its `me`
    term, none through its one-hot `ce` term);
  * `attention.mla_forward` (its prefix layer, 4 query blocks of 16);
  * `ssm.ssm_forward` (mamba2's first layer, two chunks of 32);
  * `blocks.apply_group_full` (Jamba's 8-layer group; outputs x and aux);
  * `encdec.encode` over one encoder layer (f32 frames) and
    `encdec._dec_layer_full` (a decoder layer over an f32 memory).

Tolerances: each output within 5e-4 relative L2 (readings 0 to 1.8e-4);
each gradient of a parameter or an input within 5e-3 (readings to
2.0e-3, MLA's input); the leaves summed over every token
(`tests/train_parity.py`'s SUMMED) within 2e-2, the reference summing
their broadcast bf16 products in bf16 (readings to 1.73e-2, the SSD's
conv_B_b).  Jamba's group takes the model-level tolerances of
`tests/test_torch_train_ssm.py`, 2e-2 and 3e-2: its eight layers carry
the MoE layers' x gradients (f32 sums in the port, bf16 in the
reference) down to layer 0 (readings 1.66e-2, 2.34e-2, layer 0's w_down
and conv_B_w).  Also: `ssm._softplus` equals `jax.nn.softplus` within an
ulp and takes its gradient, 1/2 at 0; `common.gather_rows`' backward is
the f32 sum of each row's contributions in index order, rounded once.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import configs, tree
from repro_torch.models import attention, blocks, common, encdec, mlp, ssm
from tests import train_reference as tr
from tests.torch_parity import rel_l2, to_torch, torch_threads  # noqa: F401
from tests.train_parity import SUMMED

pytestmark = pytest.mark.usefixtures("torch_threads")
OUT_REL_L2 = 5e-4
# (each parameter or input, the summed leaves) relative L2
TOLS = {"jamba_group": (2e-2, 3e-2)}
DEFAULT_TOLS = (5e-3, 2e-2)


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    return tr.run(tmp_path_factory.mktemp("train_layers") / "refs.pkl",
                  ["vjp:moe", "vjp:mla", "vjp:encoder", "vjp:decoder"],
                  ["vjp:ssm", "vjp:jamba_group"])


def _port_fn(kind, cfg):
    ctx = blocks.RunCtx(q_block=tr.VJP_Q_BLOCK)
    if kind == "moe":
        return cfg, lambda p, x: mlp.moe_ffn(p, x, cfg, with_aux=True)
    if kind == "mla":
        return cfg, lambda p, x: (attention.mla_forward(p, x, cfg, q_block=tr.VJP_Q_BLOCK)[0],)
    if kind == "ssm":
        return cfg, lambda p, x: (ssm.ssm_forward(p, x, cfg)[0],)
    if kind == "jamba_group":
        return cfg, lambda p, x: blocks.apply_group_full(p, x, cfg, ctx, False)[::2]
    if kind == "encoder":
        cfg = dataclasses.replace(cfg, n_enc_layers=1)
        return cfg, lambda p, x: (encdec.encode(p, x, cfg, ctx),)
    return cfg, lambda p, x, enc: (encdec._dec_layer_full(p, x, enc, cfg, ctx, False)[0],)


def _to_torch_tree(node):
    if isinstance(node, dict):
        return {k: _to_torch_tree(node[k]) for k in sorted(node)}
    return to_torch(node)


@pytest.mark.parametrize("kind", sorted(tr.VJP_CASES))
def test_layer_vjp_matches_reference(refs, kind):
    ref = refs[f"vjp:{kind}"]
    cfg, fn = _port_fn(kind, configs.get_arch(tr.VJP_CASES[kind], smoke=True))
    params = _to_torch_tree(ref["params"])
    leaves = [t.requires_grad_(True) for t in tree.leaves(params)]
    inputs = [to_torch(x).requires_grad_(True) for x in ref["inputs"]]
    outs = fn(tree.unflatten(params, leaves), *inputs)
    assert len(outs) == len(ref["outs"])
    for o, want in zip(outs, ref["outs"]):
        assert o.dtype == to_torch(want).dtype and rel_l2(want, o) <= OUT_REL_L2
    grads = torch.autograd.grad(outs, leaves + inputs, [to_torch(c) for c in ref["cts"]])
    # jax flattens (params, *inputs): the parameters' leaves, then the inputs
    names = [n for n, _ in tree.named_leaves(params)] + [f"input{i}" for i in range(len(inputs))]
    assert len(grads) == len(ref["grads"]) == len(names)
    for name, g, want in zip(names, grads, ref["grads"]):
        leaf_tol, summed_tol = TOLS.get(kind, DEFAULT_TOLS)
        tol = summed_tol if name.split("/")[-1] in SUMMED else leaf_tol
        assert g.dtype == to_torch(want).dtype and rel_l2(want, g) <= tol, (name, rel_l2(want, g))


def test_softplus_takes_jax_value_and_gradient():
    x = np.concatenate([[0.0, -0.0, 1e-30, -1e-30, 30.0, -30.0],
                        np.random.default_rng(3).standard_normal(4096) * 8]).astype(np.float32)
    want, vjp = jax.vjp(jax.nn.softplus, jnp.asarray(x))
    (want_g,) = vjp(jnp.ones_like(want))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = ssm._softplus(xt)
    (got_g,) = torch.autograd.grad(got.sum(), xt)
    # the same formula; torch's exp and XLA's differ by an ulp at times
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=3e-7, atol=0)
    assert got_g[0].item() == got_g[1].item() == float(want_g[0]) == 0.5
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-6, atol=1e-7)


def test_gather_rows_backward_is_the_f32_sum():
    """Each row's gradient is its contributions summed in f32 in index order
    and rounded once to bf16 (the reference's bf16 scatter-add rounds each
    addition)."""
    gen = torch.Generator().manual_seed(5)
    table = torch.randn(40, 24, generator=gen).to(torch.bfloat16).requires_grad_(True)
    idx = torch.randint(0, 40, (6, 50), generator=gen)
    ct = torch.randn(6, 50, 24, generator=gen).to(torch.bfloat16)
    out = common.gather_rows(table, idx)
    assert torch.equal(out.detach(), table.detach()[idx])
    (g,) = torch.autograd.grad(out, table, ct)
    want = torch.zeros(40, 24).index_add_(0, idx.reshape(-1), ct.float().reshape(-1, 24))
    assert g.dtype == torch.bfloat16 and torch.equal(g, want.to(torch.bfloat16))
