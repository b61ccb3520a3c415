"""PyTorch + CUDA port of the ZipCache serving stack (reference: `src/repro/`).

The package mirrors the JAX package's module paths (`repro_torch.core.quant`
<-> `repro.core.quant`, ...) and imports nothing from it: configs and other
host-only helpers are copied, not imported.  Every Pallas kernel on the
ported path has a hand-written CUDA C++ (sm_90a) counterpart under
`repro_torch/kernels/<name>/`, each beside its plain PyTorch version.
"""
