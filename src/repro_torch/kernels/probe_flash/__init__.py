from repro_torch.kernels.probe_flash.ops import probe_flash_attention  # noqa: F401
