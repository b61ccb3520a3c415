"""Hand-written Hopper (sm_90a) kernels of the port, one directory each.

Each directory keeps the reference's triple: `kernel.py` (the launch
wrapper and its launch counter), `ref.py` (the plain PyTorch version) and
`ops.py` (shape handling), plus `csrc/<name>.cu`.  A wrapper takes the plain
version only for tensors on the CPU; for CUDA tensors it launches its kernel
or raises.  `csrc/qattn_walk.cuh` (host side `qattn_walk.py`) is the
decode-attention walk that `paged_qattn` and `decode_qattn` share.
"""
