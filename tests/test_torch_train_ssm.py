"""The port's training loss of the SSD and hybrid families against the JAX
package, on the CPU: mamba2-2.7b (SSD layers) and jamba-v0.1-52b (one
8-layer group: seven SSD layers, an attention layer, MoE on the odd
layers), their smoke configs, as `tests/test_torch_train_families.py`
holds the other families (the reference's draws at `common.fan_in_init`,
one seeded batch, `jax.value_and_grad` op by op in a child process).

  * mamba2: the loss within 1e-4 relative, each gradient leaf within
    1.5e-2 relative L2, the leaves summed over every token within 2e-2
    (the conv weights and biases, whose broadcast bf16 products the
    reference sums in bf16; the per-head `A_log`, `D`, `dt_bias`, summed
    in f32 behind them; the norm weights).  Readings (this image): the
    loss 1.6e-7; the worst summed leaf 1.12e-2 (conv_C_b), the worst other
    3.2e-4.
  * Jamba: the loss and the aux within 1e-4; each leaf within 2e-2, the
    summed leaves within 3e-2: eight layers stack the bf16-summed
    gradients, and the summed leaves read up to 2.64e-2 (layer 0's
    A_log), the worst other 1.59e-2 (layer 0's w_B).  Both sides are far
    further from the exact gradient: every leaf past 2e-2 is held closer
    to the reference than the reference is to a float64 run of the port
    on the same weights (4-13% at those leaves).
  * `remat=True` and `remat=False` give bitwise equal losses and gradients
    for both.

The chunk scan's kinks (`jnp.clip`'s gradient at a bound is 1/2, torch's
`clamp`'s 1) sit on its decay's diagonal (cum_i - cum_i) and the state's
last row (total - cum_last): both operands are one element, so the two
halves cancel on either side.  `_softplus` takes JAX's gradient at 0
(`tests/test_torch_train_layers.py`).
"""

import pytest
import torch

from repro_torch import tree
from tests import train_reference as tr
from tests.torch_parity import rel_l2, torch_threads  # noqa: F401
from tests.train_parity import check_against_reference, port_loss_and_grads, remat_is_bitwise

pytestmark = pytest.mark.usefixtures("torch_threads")
ARCHS = ("mamba2-2.7b", "jamba-v0.1-52b")
# (each leaf, the summed leaves) relative L2
TOLS = {"mamba2-2.7b": (1.5e-2, 2e-2), "jamba-v0.1-52b": (2e-2, 3e-2)}
NOISE_FREE = 2e-2   # past this a Jamba leaf must be nearer the reference than float64 is


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    return tr.run(tmp_path_factory.mktemp("train_ssm") / "refs.pkl",
                  *([f"loss_fan_in:{a}"] for a in ARCHS))


@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_family_loss_and_grads_match_reference(refs, arch):
    from repro_torch import configs

    ref = refs[f"loss_fan_in:{arch}"]
    rel, params, batch = check_against_reference(ref, arch, *TOLS[arch])
    loud = [n for n, r in rel.items() if r > NOISE_FREE]
    assert arch == "jamba-v0.1-52b" or not loud, loud
    if loud:
        cfg = configs.get_arch(arch, smoke=True)
        b64 = {k: v.double() if v.is_floating_point() else v for k, v in batch.items()}
        _, _, g64 = port_loss_and_grads(tree.tree_map(torch.Tensor.double, params), b64, cfg)
        exact = dict(zip([n for n, _ in tree.named_leaves(params)], g64))
        for name, want in zip([n for n, _ in tree.named_leaves(params)], ref["grads"]):
            if name in loud:
                assert rel_l2(exact[name], want) > rel[name], (name, rel[name])


@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_family_remat_is_bitwise(arch):
    remat_is_bitwise(arch)
