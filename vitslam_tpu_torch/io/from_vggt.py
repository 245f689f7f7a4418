"""Load a public VGGT-1B checkpoint (facebook/VGGT-1B's ``model.pt`` or
``model.safetensors``, or a reference FeatureAlignedVGGT torch checkpoint)
into the port's parameters: the port's copy of the key rules of
scripts/convert_vggt_checkpoint.py, with no flax tree in between.

``translate_key`` gives the JAX package's flax name of an upstream key
(``VGGT_KEY_RULES``, the DPT heads through ``_translate_dpt``; None for a
key the rules drop or do not name), and ``from_jax.port_name`` the port's
parameter name of that. Upstream tensors are in torch layout, as the
port's parameters are, so two value transforms are all the layout work
(``VALUE_TRANSFORMS``):

* the aggregator's ``camera_token`` and ``register_token`` are stored
  (1, 2, K, C): the leading 1 is squeezed to the port's (2, K, C);
* the DPT heads' ``resize_layers.0/1`` are ``ConvTranspose2d`` weights,
  (in, out, k, k): ``StridedUpsample`` keeps (out, in, k, k) and transposes
  when called, so dims 0 and 1 are swapped. That holds for the track
  head's ``feature_extractor`` too, a DPTHead with the same resize layers;
  the JAX script swaps only the depth and point heads' (its
  ``VALUE_TRANSFORMS``), so there the track head's two weights load with
  in and out channels exchanged (both are square, so no shape shows it).

Every other tensor goes to its parameter as stored (the packed qkv
``Dense`` (3C, C), the per-head q / k LayerNorms (head_dim,)), its shape
checked and its values cast to the parameter's dtype.
"""
from __future__ import annotations

import re
from typing import Callable, NamedTuple, Optional

import torch
from torch import nn

from .from_jax import port_name
from .safetensors import read_safetensors

# (source regex, replacement) of a DPT head's sub-key; first match wins
_DPT_RULES: list[tuple[str, Optional[str]]] = [
    (r"projects\.(\d)\.(.*)$", r"project_\1.\2"),
    (r"resize_layers\.(\d)\.(.*)$", r"resize_layer_\1.\2"),
    (r"scratch\.output_conv1\.(.*)$", r"head_conv1.\1"),
    (r"scratch\.output_conv2\.0\.(.*)$", r"head_conv2.\1"),
    (r"scratch\.output_conv2\.2\.(.*)$", r"head_out.\1"),
]


def _translate_dpt(rest: str) -> Optional[str]:
    """A VGGT DPTHead sub-key -> the DPTHead's flax name. The 1-based
    layerK_rn / refinenetK indices become 0-based (refinenet4 fuses the
    deepest tap: fusion_3)."""
    m = re.match(r"^scratch\.layer(\d)_rn\.(.*)$", rest)
    if m:
        return f"scratch_{int(m.group(1)) - 1}.{m.group(2)}"
    m = re.match(r"^scratch\.refinenet(\d)\.resConfUnit([12])\.(.*)$", rest)
    if m:
        if (m.group(1), m.group(2)) == ("4", "1"):
            # refinenet4 fuses the deepest tap alone (no skip input): its
            # resConfUnit1 is in the checkpoint but never runs
            return None
        return f"fusion_{int(m.group(1)) - 1}.rcu{m.group(2)}.{m.group(3)}"
    m = re.match(r"^scratch\.refinenet(\d)\.out_conv\.(.*)$", rest)
    if m:
        return f"fusion_{int(m.group(1)) - 1}.out_conv.{m.group(2)}"
    for pat, repl in _DPT_RULES:
        if re.match(pat, rest):
            return re.sub(pat, repl, rest)
    return None


# (source regex, flax name) applied in order, first match wins; a None
# replacement drops the key
VGGT_KEY_RULES: list[tuple[str, Optional[str]]] = [
    # DINOv2 patch embedding inside the aggregator
    (r"^aggregator\.patch_embed\.patch_embed\.proj\.(.*)$",
     r"params.core.aggregator.patch_embed.proj.\1"),
    (r"^aggregator\.patch_embed\.(pos_embed|cls_token|register_tokens)$",
     r"params.core.aggregator.patch_embed.\1"),
    (r"^aggregator\.patch_embed\.mask_token$", None),  # masked training only
    (r"^aggregator\.patch_embed\.blocks\.(\d+)\.(.*)$",
     r"params.core.aggregator.patch_embed.blocks.\1.block.\2"),
    (r"^aggregator\.patch_embed\.norm\.(.*)$",
     r"params.core.aggregator.patch_embed.norm.\1"),
    # the alternating attention blocks
    (r"^aggregator\.frame_blocks\.(\d+)\.(.*)$",
     r"params.core.aggregator.layers.\1.frame_block.\2"),
    (r"^aggregator\.global_blocks\.(\d+)\.(.*)$",
     r"params.core.aggregator.layers.\1.global_block.\2"),
    # camera / register tokens (values: the leading 1 squeezed)
    (r"^aggregator\.camera_token$", r"params.core.aggregator.camera_token"),
    (r"^aggregator\.register_token$", r"params.core.aggregator.register_token"),
    # camera head
    (r"^camera_head\.trunk\.(\d+)\.(.*)$",
     r"params.core.camera_head.trunk_\1.\2"),
    (r"^camera_head\.poseLN_modulation\.1\.(.*)$",
     r"params.core.camera_head.modulation.\1"),
    (r"^camera_head\.(.*)$", r"params.core.camera_head.\1"),
    # track head (vggt/heads/track_head.py + track_modules/*): the torch
    # ModuleList / Sequential indices are the flax modules' _N suffixes;
    # its DPT feature_extractor goes through the DPT rules in translate_key
    (r"^track_head\.tracker\.updateformer\.(time_blocks|space_virtual_blocks"
     r"|space_point2virtual_blocks|space_virtual2point_blocks)\.(\d+)\.(.*)$",
     r"params.core.track_head.tracker.updateformer.\1_\2.\3"),
    (r"^track_head\.tracker\.(ffeat_updater|vis_predictor|conf_predictor)"
     r"\.0\.(.*)$",
     r"params.core.track_head.tracker.\1_0.\2"),
    (r"^track_head\.tracker\.(.*)$", r"params.core.track_head.tracker.\1"),
    (r"^alignment_head\.(.*)$", r"params.alignment_head.\1"),
]

# layout fixes of upstream values (torch tensors), by source key
VALUE_TRANSFORMS: list[tuple[str, Callable[[torch.Tensor], torch.Tensor]]] = [
    (r"^aggregator\.(camera_token|register_token)$", lambda v: v[0]),
    (r"^(depth_head|point_head|track_head\.feature_extractor)\.resize_layers\.[01]\.weight$",
     lambda v: v.transpose(0, 1)),
]


def transform_value(key: str, v: torch.Tensor) -> torch.Tensor:
    for pat, fn in VALUE_TRANSFORMS:
        if re.match(pat, key):
            return fn(v)
    return v


def _rule_name(key: str) -> tuple[bool, Optional[str]]:
    """(whether a rule names ``key``, its flax name or None when dropped)."""
    key = key.removeprefix("model.")
    m = re.match(r"^(depth_head|point_head|track_head\.feature_extractor)\.(.*)$", key)
    if m:
        rest = _translate_dpt(m.group(2))
        if rest is None:
            # a DPT sub-key no rule names, or refinenet4's dead unit
            return bool(re.match(r"^scratch\.refinenet4\.resConfUnit1\.", m.group(2))), None
        out = f"params.core.{m.group(1)}.{rest}"
    else:
        for pat, repl in VGGT_KEY_RULES:
            if re.match(pat, key):
                if repl is None:
                    return True, None
                out = re.sub(pat, repl, key)
                break
        else:
            return False, None
    head, _, leaf = out.rpartition(".")
    if leaf == "weight":  # flax: a norm's scale, any other module's kernel
        leaf = "scale" if re.search(r"norm", head.split(".")[-1]) else "kernel"
    return True, f"{head}.{leaf}"


def translate_key(key: str) -> Optional[str]:
    """The JAX package's flax name of an upstream key, or None."""
    return _rule_name(key)[1]


def load_vggt_state_dict(path: str) -> dict:
    """name -> CPU tensor of an upstream checkpoint: a ``.safetensors`` file
    through ``io/safetensors.py``, anything else through ``torch.load``
    (a ``"state_dict"`` entry unwrapped); both memory-mapped, not read
    whole. A leading ``model.`` is stripped from every key."""
    if path.endswith(".safetensors"):
        sd = read_safetensors(path)
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
        if "state_dict" in sd:
            sd = sd["state_dict"]
    return {k.removeprefix("model."): v for k, v in sd.items()}


class VggtMapping(NamedTuple):
    values: dict      # port parameter name -> tensor in its layout and dtype
    dropped: list     # source keys a rule maps to no parameter of this model
    unmatched: list   # source keys no rule names
    unfilled: list    # parameters no source key fills


def map_vggt(sd: dict, params: dict, strict: bool = False) -> VggtMapping:
    """The values of ``params`` (port name -> parameter, or any tensor of
    its shape and dtype, a ``meta`` one too) that the upstream state dict
    ``sd`` holds. ``dropped`` is the dead weights the rules drop (DINOv2's
    ``mask_token``, refinenet4's ``resConfUnit1``) and the keys of heads
    the model does not build (the track head, the point head of the
    pose-aligned model). A shape that differs raises ValueError naming
    both; under ``strict`` an unfilled parameter raises KeyError naming
    it."""
    values, dropped, unmatched = {}, [], []
    for key, value in sd.items():
        named, flax = _rule_name(key)
        if not named:
            unmatched.append(key)
            continue
        name = None if flax is None else port_name(flax)
        p = params.get(name)
        if p is None:
            dropped.append(key)
            continue
        if name in values:
            raise ValueError(f"{key} -> {name}: filled twice")
        value = transform_value(key, value)
        if tuple(value.shape) != tuple(p.shape):
            raise ValueError(f"{key} -> {name}: shape {tuple(value.shape)} != "
                             f"{tuple(p.shape)}")
        values[name] = value.to(p.dtype).contiguous()
    unfilled = [n for n in params if n not in values]
    if strict and unfilled:
        raise KeyError(f"{len(unfilled)} parameters no key of the checkpoint fills, e.g. "
                       f"{unfilled[:5]}")
    return VggtMapping(values, dropped, unmatched, unfilled)


def vggt_into(model: nn.Module, sd: dict, strict: bool = False) -> tuple[list, list, list]:
    """Copy the upstream state dict ``sd`` into ``model``'s parameters
    (``map_vggt``); returns (dropped, unmatched, unfilled). Unfilled
    parameters keep their values (under ``strict`` they raise)."""
    params = dict(model.named_parameters())
    mapping = map_vggt(sd, params, strict)
    with torch.no_grad():
        for name, value in mapping.values.items():
            params[name].copy_(value)
    return mapping.dropped, mapping.unmatched, mapping.unfilled
