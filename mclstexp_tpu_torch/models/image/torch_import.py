"""Reference torch ``state_dict`` -> the port's model.

Port of ``mclstexp_tpu/models/image/torch_import.py``. The reference saves
bare ``state_dict`` files (``model_result/<ds>/<section>/best_<fold>.pt``)
and starts training from ImageNet-pretrained torchvision/timm towers. The
port's modules carry the reference's key names (densenet and resnet trunks
under ``image_encoder.model``, the spot blocks, the projection heads), so a
reference checkpoint maps onto them with three changes only:
  * the ViT towers' blocks are the port's ``AttnBlock``: timm's
    ``blocks.{i}.{norm1,attn.qkv,attn.proj,norm2,mlp.fc1,mlp.fc2}`` become
    ``blocks.{i}.{attn.norm,attn.fn.to_qkv,attn.fn.to_out.0,ff.norm,
    ff.fn.net.0,ff.fn.net.3}``, ``patch_embed.proj`` the conv
    ``patch_embed``, and the final ``fc_norm`` (or CLIP's ``norm``) ``norm``;
  * the (65536, d) position tables keep their first ``pos_vocab`` rows (the
    ST presets never index past them), or a ``PosRemap``'s observed rows;
  * the mlp variant's tower attribute is ``image_ecode``, as the reference
    spells it; either spelling loads into the model's tower.
Every tensor must land on a key of the model at that key's shape and every
key of the model must be filled (a missing ``num_batches_tracked`` reads as
0, which the running statistics never use), or the import raises.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from mclstexp_tpu_torch.config import ModelConfig

# Towers the reference builds, and so the ones with a reference key layout.
DENSENETS = ("densenet121",)
RESNETS = ("res18", "resnet50", "res101", "resnet152")
VITS = ("vit", "vit_l", "clip_vit")
REFERENCE_TOWERS = DENSENETS + RESNETS + VITS

# (port, timm) names of a ViT block's parameters
_VIT_BLOCK_NAMES = (
    ("attn.norm.", "norm1."),
    ("attn.fn.to_qkv.", "attn.qkv."),
    ("attn.fn.to_out.0.", "attn.proj."),
    ("ff.norm.", "norm2."),
    ("ff.fn.net.0.", "mlp.fc1."),
    ("ff.fn.net.3.", "mlp.fc2."),
)


def vit_key_from_timm(key: str) -> str:
    """A timm ViT key -> the port's ``VisionTransformer`` key."""
    if key.startswith("patch_embed.proj."):
        return "patch_embed." + key[len("patch_embed.proj."):]
    if key.startswith(("fc_norm.", "norm.")):
        return "norm." + key.split(".", 1)[1]
    if key.startswith("blocks."):
        _, i, rest = key.split(".", 2)
        for port, timm in _VIT_BLOCK_NAMES:
            if rest.startswith(timm):
                return f"blocks.{i}.{port}{rest[len(timm):]}"
    return key


def vit_key_to_timm(key: str, pre_norm: bool) -> str:
    """The inverse of ``vit_key_from_timm``. The final norm is timm's
    ``fc_norm`` (``global_pool="avg"`` with ``norm`` an Identity), or
    ``norm`` on the CLIP trunks."""
    if key.startswith("patch_embed."):
        return "patch_embed.proj." + key[len("patch_embed."):]
    if key.startswith("norm."):
        return ("norm." if pre_norm else "fc_norm.") + key[len("norm."):]
    if key.startswith("blocks."):
        _, i, rest = key.split(".", 2)
        for port, timm in _VIT_BLOCK_NAMES:
            if rest.startswith(port):
                return f"blocks.{i}.{timm}{rest[len(port):]}"
    return key


def _check_reference_tower(encoder_name: str) -> None:
    if encoder_name not in REFERENCE_TOWERS:
        raise NotImplementedError(
            f"encoder {encoder_name!r} has no reference torch layout; have "
            f"{list(REFERENCE_TOWERS)}")


def _tower_key_to_port(key: str, encoder_name: str) -> str:
    """A key inside the reference tower (``model.…``) -> the port's tower key."""
    if encoder_name in VITS and key.startswith("model."):
        return "model." + vit_key_from_timm(key[len("model."):])
    return key


def _fill(expected: Dict[str, torch.Tensor], out: Dict[str, torch.Tensor],
          what: str) -> Dict[str, torch.Tensor]:
    """Hold ``out`` to the keys and shapes of ``expected``; returns it in
    ``expected``'s key order. A ``num_batches_tracked`` may be absent (read
    as 0) or hold one element in any shape (the JAX exporter's files hold
    (1,)), as torch's BatchNorm loads it."""
    for key in expected:
        if key.endswith("num_batches_tracked"):
            if key not in out:
                out[key] = torch.zeros((), dtype=torch.int64)
            elif out[key].numel() == 1:
                out[key] = out[key].reshape(())
    unconsumed = [k for k in out if k not in expected]
    missing = [k for k in expected if k not in out]
    if unconsumed or missing:
        raise ValueError(f"{what}: unconsumed torch tensors {unconsumed[:8]}, "
                         f"missing {missing[:8]}")
    bad = [(k, tuple(out[k].shape), tuple(w.shape)) for k, w in expected.items()
           if out[k].shape != w.shape]
    if bad:
        raise ValueError(f"{what}: shape mismatches (key, got, want) {bad[:8]}")
    return {k: out[k] for k in expected}


def import_reference_state_dict(sd: Dict[str, torch.Tensor], cfg: ModelConfig,
                                pos_remap=None) -> Dict[str, torch.Tensor]:
    """A reference mclSTExp ``state_dict`` (already key-shimmed) -> the
    state_dict of the port's ``MclSTExp(cfg)``, loadable with
    ``strict=True``. ``pos_remap`` (data/posremap.PosRemap): gather the
    position tables at the observed coordinate values instead of keeping a
    prefix (the visium preset's dense rows)."""
    from mclstexp_tpu_torch.models.mclstexp import MclSTExp

    _check_reference_tower(cfg.encoder_name)
    expected = MclSTExp(cfg, device="meta").state_dict()
    tower = "image_encoder" if cfg.variant == "attention" else "image_ecode"
    out: Dict[str, torch.Tensor] = {}
    for key, value in sd.items():
        head, _, rest = key.partition(".")
        if head in ("image_encoder", "image_ecode"):
            key = f"{tower}.{_tower_key_to_port(rest, cfg.encoder_name)}"
        elif key in ("x_embed.weight", "y_embed.weight"):
            if pos_remap is not None:
                slicer = pos_remap.slice_x if head == "x_embed" else pos_remap.slice_y
                value = torch.from_numpy(slicer(value.numpy()))
            else:
                value = value[:cfg.pos_vocab]
        if key in out:
            raise ValueError(f"two reference tensors map to {key!r}")
        out[key] = value
    return _fill(expected, out, "reference checkpoint")


def _canonicalize_tower_sd(sd: Dict[str, torch.Tensor],
                           encoder_name: str) -> Dict[str, torch.Tensor]:
    """Normalize a tower state dict to the reference's wrapped key layout:
    densenet ``conv0.*``…, resnet Sequential numbering ``0/1/4..7``, ViT timm
    names. Accepts a full reference checkpoint's image side
    (``image_encoder.model.*``), a bare torchvision tower
    (``densenet121(...).state_dict()``: ``features.*`` and an ignored
    ``classifier.*``; a resnet's ``conv1/bn1/layer{1-4}`` and an ignored
    ``fc.*``) or a bare timm ViT (an ignored ``head.*``)."""
    for wrap in ("image_encoder.model.", "model."):
        if any(k.startswith(wrap) for k in sd):
            sd = {k[len(wrap):]: v for k, v in sd.items() if k.startswith(wrap)}
            break
    sd = {k: v for k, v in sd.items() if not k.startswith(("classifier.", "fc.", "head."))}
    if encoder_name in DENSENETS:
        for wrap in ("features.", "0."):  # bare torchvision; the Sequential wrap
            if any(k.startswith(wrap) for k in sd):
                return {k[len(wrap):]: v for k, v in sd.items()}
        return sd
    if encoder_name in RESNETS and any(k.startswith("conv1.") for k in sd):
        renumber = {"conv1": "0", "bn1": "1", "layer1": "4", "layer2": "5", "layer3": "6",
                    "layer4": "7"}
        out = {}
        for k, v in sd.items():
            head, _, rest = k.partition(".")
            out[f"{renumber.get(head, head)}.{rest}" if rest else k] = v
        return out
    return sd


def import_image_tower(sd: Dict[str, torch.Tensor], encoder_name: str) -> Dict[str, torch.Tensor]:
    """An image-tower-only torch state dict (ImageNet-pretrained torchvision
    or timm weights) -> the state_dict of the port's tower
    (``build_encoder(encoder_name)``). Strict: raises on unconsumed or
    missing tower tensors."""
    from mclstexp_tpu_torch.models.image.registry import build_encoder

    _check_reference_tower(encoder_name)
    canonical = _canonicalize_tower_sd(sd, encoder_name)
    prefix = "model.0." if encoder_name in DENSENETS else "model."
    out: Dict[str, torch.Tensor] = {}
    for key, value in canonical.items():
        key = _tower_key_to_port(prefix + key, encoder_name)
        if key in out:
            raise ValueError(f"two tower tensors map to {key!r}")
        out[key] = value
    expected = build_encoder(encoder_name, device="meta")[0].state_dict()
    return _fill(expected, out, "pretrained tower")


def load_pretrained_tower(model: nn.Module, pt_path: str, encoder_name: str) -> nn.Module:
    """Graft the pretrained tower of ``pt_path`` into ``model``'s image tower
    in place (the reference's default start: an ImageNet-pretrained tower,
    the spot side at its random init); returns the model."""
    from mclstexp_tpu_torch.train.checkpoint import load_torch_state_dict

    tower_sd = import_image_tower(load_torch_state_dict(pt_path), encoder_name)
    model.tower.load_state_dict(tower_sd, strict=True)
    return model


def load_into_state(state, pt_path: str, cfg: ModelConfig, pos_remap=None):
    """Restore a reference ``.pt`` checkpoint into ``state.model`` in place
    (eval use; the optimizer is left as it is); returns the state."""
    from mclstexp_tpu_torch.train.checkpoint import load_torch_state_dict

    sd = import_reference_state_dict(load_torch_state_dict(pt_path), cfg, pos_remap)
    state.model.load_state_dict(sd, strict=True)
    return state
