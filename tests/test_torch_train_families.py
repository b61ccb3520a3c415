"""The port's training loss of the MoE, MLA, encoder-decoder and frontend
families against the JAX package, on the CPU: DeepSeek-V2-Lite (MLA +
MoE), deepseek-moe-16b (MoE), seamless-m4t-medium (the encoder-decoder on
f32 source frames) and llava-next-34b (frontend embeddings before the
text).  mamba2 and Jamba are `tests/test_torch_train_ssm.py`, each layer
alone `tests/test_torch_train_layers.py`.

  * `registry.loss_fn` and its gradients against `jax.value_and_grad` of
    the reference's `registry.loss_fn` on each smoke config, the same
    parameters and batch on both sides (`tests/train_reference.py`, op by
    op in a child process with excess precision and the algebraic
    simplifier off).  The parameters are the reference's draws at
    `common.fan_in_init`: at the reference's init the bf16 gradients are
    rounding noise (`tests/test_torch_train_loss.py` shows it),
    here 3-11% from the reference's own at DeepSeek-V2-Lite's and Jamba's
    summed leaves, two rounding orders apart.  Tolerances: the loss and
    the aux loss within 1e-4 relative; each gradient leaf within 1.5e-2
    relative L2, except the leaves summed over every token
    (`tests/train_parity.py`'s SUMMED: norm weights, MLA's `kv_norm` and
    its head-shared rope key `w_kpe`, the router), within 2e-2: the reference sums those in bf16 (the vjp of
    a broadcast bf16 product reduces in bf16,
    `test_reference_sums_broadcast_grads_in_bf16`) or behind bf16-summed
    upstream gradients, the port in f32; and the MoE dispatch's backward
    sums a token's k rows in f32 where the reference's scatter-add sums
    them in bf16, so every leaf upstream of an MoE layer is a rounding
    apart.  Readings (this image): losses 0 to 8.1e-5 relative (seamless),
    aux within 2.3e-7; the worst other leaf 1.03e-2 (seamless's decoder
    self-attention wq, where the reference itself is 1.32e-2 from a
    float64 run), the worst summed leaf 1.36e-2 (seamless's ln_x);
  * `remat=True` and `remat=False` give bitwise equal losses and gradients
    for each of these families.
"""

import pytest

from tests import train_reference as tr
from tests.torch_parity import torch_threads  # noqa: F401
from tests.train_parity import check_against_reference, remat_is_bitwise

pytestmark = pytest.mark.usefixtures("torch_threads")
ARCHS = ("deepseek-v2-lite-16b", "deepseek-moe-16b", "seamless-m4t-medium", "llava-next-34b")
LEAF_REL_L2, SUMMED_REL_L2 = 1.5e-2, 2e-2


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    return tr.run(tmp_path_factory.mktemp("train_families") / "refs.pkl",
                  [f"loss_fan_in:{a}" for a in ARCHS[:2]],
                  [f"loss_fan_in:{a}" for a in ARCHS[2:]])


@pytest.mark.parametrize("arch", ARCHS)
def test_family_loss_and_grads_match_reference(refs, arch):
    check_against_reference(refs[f"loss_fan_in:{arch}"], arch, LEAF_REL_L2, SUMMED_REL_L2)


@pytest.mark.parametrize("arch", ARCHS)
def test_family_remat_is_bitwise(arch):
    remat_is_bitwise(arch)
