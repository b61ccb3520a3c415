from repro_torch.kernels.cst_quant.ops import cst_quantize, quantize_cst  # noqa: F401
