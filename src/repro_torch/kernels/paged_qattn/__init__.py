from repro_torch.kernels.paged_qattn.ops import attend_paged, kernel_supported  # noqa: F401
