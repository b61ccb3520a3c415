from repro_torch.kernels.decode_qattn.ops import decode_attend_mixed  # noqa: F401
