"""Compression policies (port of `repro.core.policy`): ZipCache and every
baseline the paper compares against (MiKV, KIVI, GEAR, H2O, fp16), as
declarative configs that the cache (`core.kvcache`) and the engines read,
with each policy's Appendix-A compression ratio.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import quant


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    """Declarative KV-cache compression policy (see `repro.core.policy`).

    method: zipcache | mikv | kivi | gear | h2o | fp16
    high_bits/low_bits: bit-widths for salient/regular tokens.
    saliency_ratio: fraction of tokens treated as salient.
    saliency_metric: 'normalized' (Eq. 8) | 'accumulated' (Eq. 7) | 'none'.
    probe_strategy/probe_ratio: Eq. 9 probe rows.
    key_scheme/value_scheme: quantization granularity per cache.
    fp_window: recent tokens held raw; recompress_interval: Alg. 3 cadence.
    """

    method: str = "zipcache"
    high_bits: int = 4
    low_bits: int = 2
    saliency_ratio: float = 0.4
    saliency_metric: str = "normalized"
    probe_strategy: str = "random+recent"
    probe_ratio: float = 0.10
    key_scheme: str = "channelwise"
    value_scheme: str = "cst"
    group_size: int = 32
    fp_window: int = 128
    recompress_interval: int = 100
    seed: int = 0

    @staticmethod
    def zipcache(saliency_ratio: float = 0.4, high_bits: int = 4, low_bits: int = 2,
                 probe_ratio: float = 0.10, **kw) -> "CompressionConfig":
        return CompressionConfig(
            method="zipcache", high_bits=high_bits, low_bits=low_bits,
            saliency_ratio=saliency_ratio, saliency_metric="normalized",
            probe_strategy=kw.pop("probe_strategy", "random+recent"),
            probe_ratio=probe_ratio, key_scheme="channelwise", value_scheme="cst", **kw)

    @staticmethod
    def mikv(saliency_ratio: float = 0.6, high_bits: int = 4, low_bits: int = 2, **kw) -> "CompressionConfig":
        return CompressionConfig(
            method="mikv", high_bits=high_bits, low_bits=low_bits,
            saliency_ratio=saliency_ratio, saliency_metric="accumulated",
            probe_strategy="exact", key_scheme="channelwise", value_scheme="tokenwise", **kw)

    @staticmethod
    def kivi(low_bits: int = 2, fp_window: int = 128, group_size: int = 32, **kw) -> "CompressionConfig":
        return CompressionConfig(
            method="kivi", high_bits=16, low_bits=low_bits, saliency_ratio=0.0,
            saliency_metric="none", probe_strategy="none",
            key_scheme="groupwise", value_scheme="groupwise",
            group_size=group_size, fp_window=fp_window, **kw)

    @staticmethod
    def gear(bits: int = 4, **kw) -> "CompressionConfig":
        return CompressionConfig(
            method="gear", high_bits=bits, low_bits=bits, saliency_ratio=1.0,
            saliency_metric="none", probe_strategy="none",
            key_scheme="channelwise", value_scheme="tokenwise", **kw)

    @staticmethod
    def h2o(keep_ratio: float = 0.4, **kw) -> "CompressionConfig":
        return CompressionConfig(
            method="h2o", high_bits=16, low_bits=0, saliency_ratio=keep_ratio,
            saliency_metric="accumulated", probe_strategy="exact",
            key_scheme="channelwise", value_scheme="tokenwise", **kw)

    @staticmethod
    def fp16(**kw) -> "CompressionConfig":
        return CompressionConfig(
            method="fp16", high_bits=16, low_bits=16, saliency_ratio=1.0,
            saliency_metric="none", probe_strategy="none", **kw)

    @staticmethod
    def preset(name: str, **kw) -> "CompressionConfig":
        table = {
            "zipcache": CompressionConfig.zipcache, "mikv": CompressionConfig.mikv,
            "kivi": CompressionConfig.kivi, "gear": CompressionConfig.gear,
            "h2o": CompressionConfig.h2o, "fp16": CompressionConfig.fp16,
        }
        if name not in table:
            raise ValueError(f"unknown policy {name!r}; one of {sorted(table)}")
        return table[name](**kw)

    @property
    def uses_saliency(self) -> bool:
        return self.saliency_metric in ("normalized", "accumulated")

    @property
    def needs_full_attention(self) -> bool:
        """True if the policy cannot coexist with flash attention (paper §4.3)."""
        return self.uses_saliency and self.probe_strategy == "exact"

    def n_salient(self, length: int) -> int:
        return int(round(self.saliency_ratio * length))

    def compression_ratio(self, b: int, h: int, l: int, d: int) -> float:
        """Paper-style compression ratio for this policy (Appendix A algebra)."""
        if self.method == "fp16":
            return 1.0
        if self.method == "h2o":
            return quant.mixed_precision_ratio(16, 0, self.saliency_ratio, b, h, l, d, evict=True)
        if self.method == "kivi":
            return quant.mixed_precision_ratio(16, self.low_bits, 0.0, b, h, l, d,
                                               fp_window=self.fp_window,
                                               param_scheme="zipcache_baseline")
        param_scheme = ("zipcache_baseline" if self.value_scheme == "cst"
                        else "channelwise_k_tokenwise_v")
        return quant.mixed_precision_ratio(self.high_bits, self.low_bits, self.saliency_ratio,
                                           b, h, l, d, param_scheme=param_scheme)
