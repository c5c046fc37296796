"""Move a JAX param tree into the port's modules.

The flax tree (nested dicts of numpy arrays, partitioning boxes already
stripped) maps onto the reference's torch `state_dict` names, the same
correspondence as `ucf_vit_tpu/tools/convert_checkpoint.py:12-30`:

  flax                         torch                      transform
  ---------------------------  -------------------------  ----------------
  blocks_3/attn/qkv/kernel     blocks.3.attn.qkv.weight   transpose
  decoder_blocks_1/mlp/...     decoder_blocks.1.mlp...    (as blocks_i)
  norm/scale                   norm.weight                identity
  token_embed/proj/kernel      token_embeds.proj.weight   [*k,i,o]->[o,i,*k]
  token_embed/{norm_in,proj,norm_out}
                               token_embeds.{0,1,2}       (adaptive LN-Linear-LN)
  token_embed_2/proj/kernel    token_embeds.2.proj.weight (varemb: one a variable)
  var_agg/{q,kv,proj}/kernel   var_agg.{q,kv,proj}.weight transpose
  var_embed, var_query         same name                  identity
  adaptive_pos_dep_emb/linear/kernel, decoder_adaptive_pos_dep_emb/linear/kernel
                               (decoder_)adaptive_pos_dep_emb.0.weight  transpose
  pos_embed, cls_token, gamma  same name                  identity
  mask_token, decoder_pos_embed same name                 identity
  time_embedding_map/linear1/kernel
                               timeEmbeddingMap.linear1.weight  transpose
  encoder1/layer/conv1/kernel  encoder1.layer.conv1.weight [*k,i,o]->[o,i,*k]
  encoder2/up_0/kernel         encoder2.blocks.0.0.weight [*k,i,o]->[i,o,*k] + flip
  encoder2/res_0/conv1/kernel  encoder2.blocks.0.1.conv1.weight
  decoder5/transp_conv/kernel  decoder5.transp_conv.weight (ConvTranspose, + flip)
  decoder5/conv_block/conv1/kernel
                               decoder5.conv_block.conv1.weight
  out/conv/kernel, mlp_head/kernel
                               out.conv.weight, mlp_head.weight
  neck/kernel                  neck.0.weight              (SAP's ConvTranspose, + flip)
  mask_header/kernel           mask_header.0.weight       [*k,i,o]->[o,i,*k]
  blocks_1/moe_mlp/wi          blocks.1.moe_mlp.wi        identity (router_kernel, wi,
                                                          bi, wo, bo: the JAX layouts)

A ConvTranspose kernel (a module named `neck`, `transp_conv`,
`transp_conv_init` or `up_<i>`) is mirrored in every spatial axis on the way: flax's transposed
convolution does not mirror the kernel, torch's does
(`ucf_vit_tpu/tools/convert_checkpoint.py:29-30`). With kernel = stride
there is no overlap, so a missing flip would only permute each block.

It covers the ported modules (PatchEmbed, LinearTokenEmbed, AdaptivePosMLP,
Mlp, MoeMlp, Attention, VariableMappingAttention, Block, VIT with or without the
variable embedding, MAE, DiffusionVIT, UNETR and its decoder blocks, SAP;
DiffusionVIT's time table is a constant on both sides, in neither tree),
from a whole model or from one of them. A scan-layers tree (`scan_layers=True` on
the JAX side: `blocks/block/<leaves stacked [depth, ...]>`, recognised as
`ucf_vit_tpu/tools/convert_checkpoint.py:160-185` does) is unstacked into
`blocks.{i}.*` first; MAE's decoder blocks stay per layer in such a tree
(`decoder_blocks_{i}`), as the JAX model keeps them without a pipeline.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch


# LinearTokenEmbed's children -> their places in the reference's nn.Sequential
_LTE_CHILD = {"norm_in": "0", "proj": "1", "norm_out": "2"}
# the flax modules that are a Sequential of (Linear, GELU) in torch
_SEQ0_PARENTS = ("adaptive_pos_dep_emb", "decoder_adaptive_pos_dep_emb")
# the flax modules whose kernel is a ConvTranspose's
_CONVT = re.compile(r"neck|transp_conv|transp_conv_init|up_\d+")
# the flax modules that are a Sequential of one conv in torch (SAP's)
_SEQ_OF_ONE = ("neck", "mask_header")


def _segment(name: str, parent: str = "", lte: bool = False) -> str:
    """One flax path segment in torch's spelling; `lte`: the segment is a
    child of a LinearTokenEmbed (a tree that holds `norm_in`)."""
    if lte and name in _LTE_CHILD:
        return _LTE_CHILD[name]
    if parent in _SEQ0_PARENTS and name == "linear":
        return "0"
    m = re.fullmatch(r"(decoder_blocks|blocks)_(\d+)", name)
    if m:
        return f"{m.group(1)}.{m.group(2)}"
    m = re.fullmatch(r"token_embed(?:_(\d+))?", name)  # varemb: one embed a variable
    if m:
        return "token_embeds" + (f".{m.group(1)}" if m.group(1) else "")
    if name in _SEQ_OF_ONE:
        return f"{name}.0"
    if name == "time_embedding_map":
        return "timeEmbeddingMap"
    m = re.fullmatch(r"(up|res)_(\d+)", name)  # UnetrPrUpBlock's (upsample, res block) pairs
    if m:
        return f"blocks.{m.group(2)}.{0 if m.group(1) == 'up' else 1}"
    return name


def _leaves(tree: Dict[str, Any], path: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _torch_segments(params: Dict[str, Any], path: Tuple[str, ...]) -> list:
    """The torch spelling of a leaf's flax path, its last segment left out."""
    out, tree, parent = [], params, ""
    for name in path[:-1]:
        out.append(_segment(name, parent, lte="norm_in" in tree))
        tree, parent = tree[name], name
    return out


def _is_scan_blocks(tree: Any) -> bool:
    return isinstance(tree, dict) and set(tree) == {"block"}


def _unstack_scan(params: Dict[str, Any]) -> Dict[str, Any]:
    """Replace a scan-layers `blocks` container (stacked leaves, leading depth
    dim) with per-layer `blocks_{i}` subtrees."""
    stacked = params["blocks"]["block"]
    depth = int(np.asarray(next(_leaves(stacked))[1]).shape[0])

    def layer(tree, i):
        if isinstance(tree, dict):
            return {k: layer(v, i) for k, v in tree.items()}
        return np.asarray(tree)[i]

    out = {k: v for k, v in params.items() if k != "blocks"}
    for i in range(depth):
        out[f"blocks_{i}"] = layer(stacked, i)
    return out


def jax_to_torch_state(params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Flax param tree -> `{torch state_dict key: numpy array}`."""
    if _is_scan_blocks(params.get("blocks")):
        params = _unstack_scan(params)
    out: Dict[str, np.ndarray] = {}
    for path, leaf in _leaves(params):
        arr = np.asarray(leaf)
        name = path[-1]
        if name == "kernel":
            name = "weight"
            nd = arr.ndim - 2
            if arr.ndim == 2:  # dense [in, out] -> [out, in]
                arr = arr.T
            elif len(path) > 1 and _CONVT.fullmatch(path[-2]):
                # ConvTranspose [*k, in, out] -> [in, out, *k], mirrored
                arr = arr[(slice(None, None, -1),) * nd].transpose(nd, nd + 1, *range(nd)).copy()
            else:  # conv [*k, in, out] -> [out, in, *k]
                arr = arr.transpose(nd + 1, nd, *range(nd))
        elif name == "scale":  # LayerNorm
            name = "weight"
        key = ".".join(_torch_segments(params, path) + [name])
        out[key] = np.ascontiguousarray(arr)
    return out


@torch.no_grad()
def load_jax_params(model: torch.nn.Module, params: Dict[str, Any]) -> torch.nn.Module:
    """Copy a flax param tree into `model` (strict: every key must match in
    name and shape). Returns the model."""
    state = {k: torch.tensor(v) for k, v in jax_to_torch_state(params).items()}
    model.load_state_dict(state, strict=True)
    return model
