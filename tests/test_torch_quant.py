"""Port parity: packing, the quantizers, and the CSTQuant kernel's plain
version, against the JAX package on the same inputs (codes exact)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packing as jpack
from repro.core import quant as jquant
from repro.kernels.cst_quant import ops as jcst_ops
from repro_torch.core import packing, quant
from repro_torch.kernels.cst_quant import kernel as cst_kernel
from repro_torch.kernels.cst_quant import ops as cst_ops
from tests.torch_parity import to_np, to_torch, torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")


def _x(rng, shape, dtype):
    x = jnp.asarray(rng.normal(size=shape).astype(np.float32) * 2)
    return x.astype(dtype)


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_pack_unpack_roundtrip_and_layout(bits, rng):
    codes = rng.integers(0, 2**bits, size=(3, 5, 32)).astype(np.uint8)
    packed = packing.pack(torch.from_numpy(codes), bits)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpack.pack(jnp.asarray(codes), bits)))
    np.testing.assert_array_equal(packing.unpack(packed, bits).numpy(), codes)


@pytest.mark.parametrize("scheme", ["channelwise", "tokenwise", "cst", "groupwise"])
@pytest.mark.parametrize("bits", [2, 4])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_quantizers_match_reference(scheme, bits, dtype, rng):
    x = _x(rng, (2, 3, 40, 64), dtype)
    want = jquant.quantize(x, bits, scheme)
    got = quant.quantize(to_torch(x), bits, scheme)
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    for a, b in ((got.scale, want.scale), (got.zero, want.zero),
                 (got.channel_scale, want.channel_scale)):
        if b is None:
            assert a is None
        else:
            assert a.dtype == to_torch(b).dtype
            np.testing.assert_array_equal(to_np(a), to_np(b))
    np.testing.assert_array_equal(to_np(got.dequantize()), to_np(want.dequantize()))


@pytest.mark.parametrize("bits", [2, 4])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_cst_kernel_plain_version_matches_quantize_cst(bits, dtype, rng):
    """The kernel route on the CPU (its plain version) equals the core's
    quantize_cst for V, with the channel scale taken over padding rows too:
    a store whose slots read tokens 0-39 and 8 zero rows (slot index -1)."""
    x = np.array(_x(rng, (2, 2, 48, 128), dtype).astype(jnp.float32))
    x[:, :, 40:] = 0.0  # a store's zero rows
    xj = jnp.asarray(x).astype(dtype)
    want = jquant.quantize_cst(xj, bits)
    idx = torch.arange(48, dtype=torch.int32).masked_fill(torch.arange(48) >= 40, -1)
    src = to_torch(xj)[:, :, :40]
    launches = cst_kernel.KERNEL.launches
    _, got = cst_ops.quantize_store(src, src, idx.expand(2, 48), bits)
    assert cst_kernel.KERNEL.launches == launches  # CPU tensors never launch
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    for a, b in ((got.scale, want.scale), (got.zero, want.zero),
                 (got.channel_scale, want.channel_scale)):
        assert a.dtype == to_torch(b).dtype
        np.testing.assert_array_equal(to_np(a), to_np(b))


@pytest.mark.parametrize("bits", [2, 4])
def test_cst_kernel_plain_version_matches_pallas_interpret(bits, rng):
    """Against the Pallas kernel in interpret mode, on f32 inputs (where the
    reference's own kernel tests hold its codes exact): codes equal, and the
    params equal once cast to the serving store dtype, bf16 (the jitted
    kernel's f32 params may differ from the eager path's in the last bit)."""
    x = _x(rng, (2, 64, 128), jnp.float32)
    wc, ws, wz, wcs = jcst_ops.cst_quantize(x, bits, interpret=True)
    gc, gs, gz, gcs = cst_ops.cst_quantize(to_torch(x), bits)
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    for a, b in ((gs, ws), (gz, wz), (gcs, wcs)):
        np.testing.assert_array_equal(to_np(a.to(torch.bfloat16)),
                                      to_np(jnp.asarray(b).astype(jnp.bfloat16)))
