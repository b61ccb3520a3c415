"""Decoder blocks (port of `repro.models.blocks`): the run context, layer
schemas by (mixer, ffn) kind, and one layer's prefill and decode steps.

Mixers: "attn" (GQA), "mla" (DeepSeek-V2's latent attention; its cache
holds the rope key as the K stream and the latent as the V stream, one kv
head) and "ssm" (the Mamba2 SSD mixer; its cache element is the layer's
`ssm.SSMState`, never compressed).  FFNs: "dense" (SwiGLU), "moe"
(fine-grained experts) or "none".
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import backend as backend_lib
from repro_torch.core import kvcache as kvc
from repro_torch.core import precision as precision_lib
from repro_torch.core import saliency as sal
from repro_torch.core.policy import CompressionConfig
from repro_torch.models import attention as attn
from repro_torch.models import common, parallel
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import ParamDef


def layer_schema(cfg: ArchConfig, mixer: str, ffn: str) -> dict:
    e = cfg.d_model
    s = {"ln1": ParamDef((e,), ("embed",), init="ones")}
    if mixer == "attn":
        s["attn"] = attn.gqa_schema(cfg)
    elif mixer == "mla":
        s["attn"] = attn.mla_schema(cfg)
    elif mixer == "ssm":
        s["ssm"] = ssm_mod.ssm_schema(cfg)
    else:
        raise ValueError(mixer)
    if ffn == "dense":
        s["ln2"] = ParamDef((e,), ("embed",), init="ones")
        s["mlp"] = mlp_mod.dense_mlp_schema(cfg)
    elif ffn == "moe":
        s["ln2"] = ParamDef((e,), ("embed",), init="ones")
        s["moe"] = mlp_mod.moe_schema(cfg)
    elif ffn != "none":
        raise ValueError(ffn)
    return s


def group_schema(cfg: ArchConfig) -> dict:
    return {f"sub{j}": layer_schema(cfg, m, f) for j, (m, f) in enumerate(cfg.layer_kinds())}


class RunCtx:
    """Per-call context: compression policy, probes, cache budget, kernels.

    `use_kernels` routes prefill attention through `kernels.probe_flash`;
    the cache backend carries its own switch for `cst_quant`, `decode_qattn`
    and `paged_qattn` (`backend_lib.of(ccfg, use_kernels=...)`).

    `precision`: the resolved (L, h, 2) ceiling table of a precision map
    (`core.precision`), read at every quantization site; None is the
    bitwise-default path.  It lives here, not on the backend, because only
    the model code knows the layer index of each compress / recompress.

    The reference's two levers: `decode_impl` ("ref" or "int8_algebra") is
    the algebra of the cache's plain decode attention (the gather route and
    the probe steps' exact slot weights), and `compact_softmax` gives the
    plain prefill attention bf16 logits and probabilities.

    `mesh` (a `launch.mesh.Mesh`, None without one) and its `data_axes`, as
    the reference's: the training mesh the model's layers hand to the
    collectives of `models.parallel`.
    """

    def __init__(self, mesh=None, data_axes=("data",), ccfg: Optional[CompressionConfig] = None,
                 probe: Optional[sal.ProbeSpec] = None, max_cache_len: int = 0,
                 q_block: int = 512, use_kernels: bool = False,
                 decode_impl: str = "ref", compact_softmax: bool = False,
                 backend=None, precision=None):
        self.mesh = mesh
        self.data_axes = tuple(data_axes)
        self.ccfg = ccfg
        self.probe = probe
        self.max_cache_len = max_cache_len
        self.q_block = q_block
        self.use_kernels = use_kernels
        self.decode_impl = decode_impl
        self.compact_softmax = compact_softmax
        self.backend = backend if backend is not None else backend_lib.of(
            ccfg, use_kernels=use_kernels)
        self.precision = precision
        self._layer_effs = {}

    def layer_eff(self, layer: int, n_heads: int, device=None):
        """This layer's `precision.LayerEff` on `device` (None without a
        map).  n_heads: the cache's head count; the table is min-pooled onto
        it.  Made once per (layer, heads, device) and kept."""
        if self.precision is None or self.ccfg is None:
            return None
        key = (layer, n_heads, str(device))
        eff = self._layer_effs.get(key)
        if eff is None:
            table = precision_lib.pooled_table(self.precision, n_heads)
            eff = precision_lib.layer_eff(table, layer, self.ccfg.high_bits,
                                          self.ccfg.low_bits, device=device)
            self._layer_effs[key] = eff
        return eff


def _ffn(params: dict, x: torch.Tensor, cfg: ArchConfig, ffn: str,
         active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x plus the layer's FFN of its post-attention norm at decode (x: (b,
    e); `active`: the live rows, the only ones that take MoE expert
    slots)."""
    if ffn == "none":
        return x
    h = common.rms_norm(x, params["ln2"], cfg.norm_eps)
    if ffn == "dense":
        return x + mlp_mod.dense_mlp(params["mlp"], h)
    return x + mlp_mod.moe_ffn(params["moe"], h[:, None, :], cfg, active=active)[:, 0]


def _ffn_full(params: dict, x: torch.Tensor, cfg: ArchConfig, ffn: str, ctx: RunCtx
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (b, s, e) plus the layer's FFN, and its aux loss (the MoE router's
    load balancing; zero for a dense FFN or none)."""
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if ffn == "none":
        return x, zero
    h = common.rms_norm(x, params["ln2"], cfg.norm_eps)
    if ffn == "dense":
        return x + mlp_mod.dense_mlp(params["mlp"], h, ctx.mesh), zero
    y, aux = mlp_mod.moe_ffn(params["moe"], h, cfg, with_aux=True, mesh=ctx.mesh,
                             data_axes=ctx.data_axes)
    return x + y, aux


def apply_layer_full(params: dict, x: torch.Tensor, cfg: ArchConfig, mixer: str, ffn: str,
                     ctx: RunCtx, build_cache: bool, layer: int = 0
                     ) -> Tuple[torch.Tensor, Any, torch.Tensor]:
    """One layer over the full sequence (the training forward under autograd,
    or the serving prefill).  Returns (x, cache element | None, aux loss),
    the aux loss f32 as the reference's.  `layer`: the absolute layer index,
    for the precision map.  An SSM layer's element is its final state: no
    compression, no saliency.  On a mesh the layer's weights are gathered
    here (`parallel.gather_tree`)."""
    params = parallel.gather_tree(params, ctx.mesh)
    h = common.rms_norm(x, params["ln1"], cfg.norm_eps)
    if mixer == "ssm":
        y, state = ssm_mod.ssm_forward(params["ssm"], h, cfg)
        x, aux_loss = _ffn_full(params, x + y, cfg, ffn, ctx)
        return x, state if build_cache else None, aux_loss
    fwd = attn.gqa_forward if mixer == "attn" else attn.mla_forward
    y, aux = fwd(params["attn"], h, cfg, probe=ctx.probe, q_block=ctx.q_block,
                 use_kernel=ctx.use_kernels, compact=ctx.compact_softmax, mesh=ctx.mesh)
    cache_el = None
    if build_cache:
        cache_el = ctx.backend.compress_prefill(
            aux.k, aux.v, aux.saliency, ctx.max_cache_len, probe_nnz=aux.probe_nnz,
            dtype=x.dtype, eff=ctx.layer_eff(layer, aux.k.shape[1], device=aux.k.device))
    x, aux_loss = _ffn_full(params, x + y, cfg, ffn, ctx)
    return x, cache_el, aux_loss


def apply_group_full(params: dict, x: torch.Tensor, cfg: ArchConfig, ctx: RunCtx,
                     build_cache: bool, group: int = 0) -> Tuple[torch.Tensor, list, torch.Tensor]:
    """One scan group's sub-layers over the full sequence: (x, the sub-layers'
    cache elements (None each without build_cache), the group's summed aux
    loss).  The absolute layer of sub-layer j is first_dense_layers + group
    * scan_group + j."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    els = []
    for j, (m, f) in enumerate(cfg.layer_kinds()):
        x, el, aux = apply_layer_full(params[f"sub{j}"], x, cfg, m, f, ctx, build_cache,
                                      layer=cfg.first_dense_layers + group * cfg.scan_group + j)
        aux_total = aux_total + aux
        els.append(el)
    return x, els, aux_total


def apply_layer_decode(params: dict, x_t: torch.Tensor, cfg: ArchConfig, mixer: str, ffn: str,
                       cache_el: Any, ctx: RunCtx, is_probe,
                       active: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Any]:
    """One layer, one token: append this token's K/V, attend over the cache
    (exact slot weights on probe steps), fold the probe row.  `is_probe` and
    `active` as in `core.backend`: inactive rows append nothing.  MLA appends
    the rope key and the latent first (the token attends to itself), then
    reads the cache's mixed-layout view.  An SSM layer advances its state;
    inactive rows keep their old state."""
    be = ctx.backend
    h = common.rms_norm(x_t, params["ln1"], cfg.norm_eps)
    if mixer == "ssm":
        y, new_el = ssm_mod.ssm_decode(params["ssm"], h, cfg, cache_el)
        if active is not None:
            new_el = kvc.tree_select_rows(active, new_el, cache_el)
        return _ffn(params, x_t + y, cfg, ffn, active), new_el
    position = cache_el.length
    if mixer == "attn":
        q_t, k_t, v_t = attn.gqa_decode_qkv(params["attn"], h, cfg, position)
        cache_el = be.append(cache_el, k_t, v_t, active=active)
        dec = be.attend(q_t, cache_el, is_probe, impl=ctx.decode_impl)
        cache_el = be.update_probe(cache_el, dec.slot_weights, is_probe)
        y = common.out_proj(dec.out, params["attn"]["wo"])
    else:
        k_pe_t, latent_t = attn.mla_kv_t(params["attn"], h, cfg, position)
        cache_el = be.append(cache_el, k_pe_t[:, None], latent_t[:, None], active=active)
        y, slot_w = attn.mla_decode(params["attn"], h, be.dense(cache_el), cfg, position,
                                    impl=ctx.decode_impl)
        cache_el = be.update_probe(cache_el, slot_w, is_probe)
    return _ffn(params, x_t + y, cfg, ffn, active), cache_el


def init_mla_cache(cfg: ArchConfig, ctx: RunCtx, b: int, dtype=torch.bfloat16, device=None):
    """MLA latent cache: one kv head; K stream the rope key (dim p), V stream
    the latent (rank r).  ZipCache's schemes map onto the two: channelwise
    K on the rope key, CSTQuant V on the latent."""
    return ctx.backend.init_cache(b, 1, cfg.rope_head_dim, ctx.max_cache_len, dtype,
                                  d_v=cfg.kv_lora_rank, device=device)


def init_layer_cache(cfg: ArchConfig, ctx: RunCtx, mixer: str, b: int, dtype=torch.bfloat16,
                     device=None):
    """An empty cache element of a layer of kind `mixer` (an SSM layer's: a
    zero state, its conv tails in `dtype`)."""
    if mixer == "ssm":
        return ssm_mod.init_state(cfg, b, dtype, device=device)
    if mixer == "mla":
        return init_mla_cache(cfg, ctx, b, dtype, device=device)
    return ctx.backend.init_cache(b, cfg.n_kv_heads, cfg.hd, ctx.max_cache_len, dtype,
                                  device=device)


def cache_heads(cfg: ArchConfig, mixer: str) -> int:
    """The kv heads of a layer's cache (MLA: the one shared latent)."""
    return 1 if mixer == "mla" else cfg.n_kv_heads
