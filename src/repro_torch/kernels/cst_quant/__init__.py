from repro_torch.kernels.cst_quant.ops import cst_quantize, quantize_store  # noqa: F401
