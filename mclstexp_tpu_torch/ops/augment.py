"""Train-time image augmentation on the device, as pure functions of draws.

Port of ``mclstexp_tpu/ops/augment.py``: the "st" path, ColorJitter(0.5,
0.5, 0.5) with a per-image random op order, horizontal flip, and rotation
by U(-180, 180) degrees (nearest neighbour, zero fill, positive = CCW); and
the Visium "tenx" path, horizontal and vertical flips and a rotation by a
multiple of 90 degrees, optionally on the raw 0-255 scale.

torch cannot reproduce ``jax.random`` draws, so every transform takes its
random numbers explicitly (``StDraws``, ``TenxDraws``), and
``sample_st_draws`` / ``sample_tenx_draws`` draw them from a
``torch.Generator``. Tests hand both packages the same draws.

The default rotation (``rotate_batch_paeth``) is Paeth's three shears, each
one launch of the ``row_shift`` kernel (two in its row layout, one in its
column layout).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from mclstexp_tpu_torch.ops.row_shift import row_shift

_LUMA = (0.299, 0.587, 0.114)  # ITU-R 601-2

# The six orders of (brightness, contrast, saturation), indexed by the
# per-image order draw (the JAX build's _PERMS).
_PERMS = ((0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0))


@dataclasses.dataclass
class StDraws:
    """The random numbers of one "st" augmentation of a batch of B images."""

    jitter: torch.Tensor  # (B, 3) float: brightness, contrast, saturation factors
    order: torch.Tensor  # (B,) int in [0, 6): index into _PERMS
    hflip: torch.Tensor  # (B,) bool
    angles: torch.Tensor  # (B,) float degrees


def reseed(generator: torch.Generator, *key: int) -> torch.Generator:
    """Seed ``generator`` from the non-negative integers ``key`` (hashed by
    numpy's ``SeedSequence``) and return it. Draws keyed by where they are
    taken (seed, fold, epoch, step), as the JAX build keys them with
    ``fold_in``, do not depend on what was drawn before: a resumed fold
    draws what an uninterrupted one would."""
    seed = np.random.SeedSequence(list(key)).generate_state(1, np.uint64)[0]
    return generator.manual_seed(int(seed))


def sample_st_draws(generator: torch.Generator, batch: int, device) -> StDraws:
    """Draw the "st" augmentation: factors U(0.5, 1.5), a uniform op order,
    a fair-coin flip and an angle U(-180, 180), independently per image."""
    def u(shape, lo, hi):
        return torch.rand(shape, generator=generator, device=device) * (hi - lo) + lo

    return StDraws(
        jitter=u((batch, 3), 0.5, 1.5),
        order=torch.randint(0, len(_PERMS), (batch,), generator=generator, device=device),
        hflip=torch.rand((batch,), generator=generator, device=device) < 0.5,
        angles=u((batch,), -180.0, 180.0),
    )


def _blend(img1: torch.Tensor, img2: torch.Tensor, ratio: torch.Tensor) -> torch.Tensor:
    return torch.clamp(ratio * img1 + (1.0 - ratio) * img2, 0.0, 1.0)


def _luma_cm(x: torch.Tensor, round_last: bool = True) -> torch.Tensor:
    """Grayscale, channel-major: (B, 3, H, W) -> (B, H, W), the weights
    rounded to x's type first, as the JAX function casts them.
    ``round_last=False`` leaves the last add in fp32 (a bf16 x): what XLA
    computes where the gray image feeds the contrast's fp32 mean (it drops
    the bf16 round trip between the add and the mean's upcast)."""
    w = [float(torch.tensor(c, dtype=x.dtype)) for c in _LUMA]
    partial, last = x[:, 0] * w[0] + x[:, 1] * w[1], x[:, 2] * w[2]
    return partial + last if round_last else partial.float() + last.float()


def color_jitter(imgs: torch.Tensor, factors: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """ColorJitter over a (B, H, W, 3) batch with per-image factors (B, 3) and
    per-image op order (B,), torchvision semantics (brightness blends toward
    0, contrast toward the mean gray level, saturation toward the gray
    image)."""
    x = imgs.permute(0, 3, 1, 2)  # (B, 3, H, W)
    f = factors.to(imgs.dtype)[:, :, None, None, None]  # (B, 3, 1, 1, 1)
    fb, fc, fs = f[:, 0], f[:, 1], f[:, 2]
    perms = torch.tensor(_PERMS, device=imgs.device)[order.long()]  # (B, 3)

    def apply(op: int, x: torch.Tensor) -> torch.Tensor:
        if op == 0:
            return _blend(x, torch.zeros_like(x), fb)
        if op == 1:
            # the gray level's mean sums in fp32 and rounds once (jnp.mean of bf16)
            gm = _luma_cm(x, round_last=False).mean(dim=(-2, -1)).to(x.dtype)
            gm = gm[:, None, None, None]
            return _blend(x, gm, fc)
        return _blend(x, _luma_cm(x)[:, None], fs)

    for step in range(3):
        which = perms[:, step][:, None, None, None]
        x = torch.where(which == 0, apply(0, x),
                        torch.where(which == 1, apply(1, x), apply(2, x)))
    return x.permute(0, 2, 3, 1)


def rotate_batch(imgs: torch.Tensor, angles_deg: torch.Tensor,
                 hflip: torch.Tensor | None = None) -> torch.Tensor:
    """Rotate a (B, H, W, C) batch about image centers by nearest-neighbour
    inverse mapping (round half to even), zero fill; ``hflip`` (B,) flips
    horizontally before the rotation by mirroring the source x."""
    b, h, w = imgs.shape[:3]
    theta = angles_deg * (math.pi / 180.0)
    cos, sin = torch.cos(theta)[:, None, None], torch.sin(theta)[:, None, None]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy = torch.arange(h, dtype=torch.float32, device=imgs.device)[:, None].expand(h, w) - cy
    xx = torch.arange(w, dtype=torch.float32, device=imgs.device)[None, :].expand(h, w) - cx
    sxr = torch.round(cos * xx - sin * yy + cx)
    syr = torch.round(sin * xx + cos * yy + cy)
    valid = (sxr >= 0) & (sxr <= w - 1) & (syr >= 0) & (syr <= h - 1)
    sxc = sxr.clamp(0, w - 1).long()
    syc = syr.clamp(0, h - 1).long()
    if hflip is not None:
        sxc = torch.where(hflip[:, None, None], w - 1 - sxc, sxc)
    boff = (torch.arange(b, device=imgs.device) * (h * w))[:, None, None]
    flat = (boff + syc * w + sxc).reshape(-1)
    out = imgs.reshape(b * h * w, -1)[flat].reshape(imgs.shape)
    return torch.where(valid[..., None], out, torch.zeros((), dtype=imgs.dtype,
                                                          device=imgs.device))


def paeth_shears(angles_deg: torch.Tensor, size: int):
    """The quarter turns and the shifts of the Paeth rotation of (B,) angles
    on size x size images: (k (B,) long in [0, 4), shear_x (B, size) and
    shear_y (B, size) int32). The angle is reduced to a residual t in
    [-45, 45] degrees by k quarter turns; shear_x = round(tan(t/2) * c),
    shear_y = round(-sin(t) * c), c = arange(size) - (size - 1) / 2."""
    k90 = torch.round(angles_deg / 90.0)
    theta = (angles_deg - k90 * 90.0) * (math.pi / 180.0)  # [-45, 45] residual
    centered = torch.arange(size, dtype=torch.float32, device=angles_deg.device) - (size - 1) / 2.0
    shear_x = torch.round(torch.tan(theta / 2.0)[:, None] * centered).int()  # (B, H)
    shear_y = torch.round(-torch.sin(theta)[:, None] * centered).int()  # (B, W)
    return torch.remainder(k90, 4).long(), shear_x, shear_y


def rotate_batch_paeth(imgs: torch.Tensor, angles_deg: torch.Tensor,
                       hflip: torch.Tensor | None = None) -> torch.Tensor:
    """Rotate a square (B, H, H, C) batch by Paeth's three shears.

    R(t) = ShearX(a) . ShearY(b) . ShearX(a), a = tan(t/2), b = -sin(t),
    after reducing the angle to [-45, 45] with an exact rot90. Each shear is
    one ``row_shift`` launch: the two row shears run the kernel's row layout
    on a contiguous image, the column shear its column layout on the
    transposed view. Multiples of 90 degrees are exact; other angles
    resample slightly differently from ``rotate_batch`` (same distribution
    of transforms).
    """
    b, h, w = imgs.shape[:3]
    if h != w:
        raise ValueError(f"paeth rotation needs square images, got {tuple(imgs.shape)}")
    if hflip is not None:
        imgs = torch.where(hflip[:, None, None, None], imgs.flip(2), imgs)

    k, shear_x, shear_y = paeth_shears(angles_deg, h)
    k = k[:, None, None, None]
    # The row shears need a contiguous base. torch.where takes its output
    # layout from its leading operands, so the contiguous ones come before
    # the rot90 views (transposed strides) and .contiguous() copies nothing.
    base = torch.where(
        k == 0, imgs,
        torch.where(k == 2, imgs.flip(1, 2),
                    torch.where(k == 1, torch.rot90(imgs, 1, dims=(1, 2)),
                                torch.rot90(imgs, 3, dims=(1, 2)))),
    ).contiguous()

    out = row_shift(base, shear_x)
    out = row_shift(out.transpose(1, 2), shear_y).transpose(1, 2)  # column shear
    return row_shift(out, shear_x)


def train_augment_inline(patches_u8: torch.Tensor, draws: StDraws,
                         dtype: torch.dtype = torch.float32,
                         rot_impl: str = "paeth") -> torch.Tensor:
    """uint8 (B, H, W, 3) patches -> jittered, flipped, rotated float [0, 1].

    The patches are scaled by ``to_float`` and rounded to ``dtype``: bit-equal,
    for every uint8 value, to the JAX step's jitted ``(u.astype(dtype) /
    dtype(255)).astype(dtype)``, which XLA compiles into a float32 multiply
    by float32(1 / 255) and one rounding to ``dtype``. In bf16 (the model's
    compute dtype, as the JAX step passes it) the jitter runs in bf16,
    rounding after every operation as XLA does, and the Paeth shears move
    bf16 pixels.
    """
    imgs = to_float(patches_u8).to(dtype)
    imgs = color_jitter(imgs, draws.jitter, draws.order)
    h, w = imgs.shape[1], imgs.shape[2]
    if rot_impl == "paeth" and h == w and h % 8 == 0:
        return rotate_batch_paeth(imgs, draws.angles, hflip=draws.hflip)
    return rotate_batch(imgs, draws.angles, hflip=draws.hflip)


# The "tenx" rotation draw r indexes these quarter turns of torch.rot90 (k
# counter-clockwise): 180, 90, 0 and -90 degrees, the reference's choices.
TENX_QUARTER_TURNS = (2, 1, 0, 3)


@dataclasses.dataclass
class TenxDraws:
    """The random numbers of one "tenx" augmentation of a batch of B images."""

    hflip: torch.Tensor  # (B,) bool
    vflip: torch.Tensor  # (B,) bool
    rot: torch.Tensor  # (B,) int in [0, 4): index into TENX_QUARTER_TURNS


def sample_tenx_draws(generator: torch.Generator, batch: int, device) -> TenxDraws:
    """Draw the "tenx" augmentation: two fair-coin flips and a uniform choice
    of four rotations, independently per image."""
    return TenxDraws(
        hflip=torch.rand((batch,), generator=generator, device=device) < 0.5,
        vflip=torch.rand((batch,), generator=generator, device=device) < 0.5,
        rot=torch.randint(0, len(TENX_QUARTER_TURNS), (batch,), generator=generator,
                          device=device),
    )


def tenx_augment(patches_u8: torch.Tensor, draws: TenxDraws,
                 raw_scale: bool = False) -> torch.Tensor:
    """The Visium transform (port of ``tenx_augment_inline``): per image a
    horizontal flip, a vertical flip, then a rotation by 180, 90, 0 or -90
    degrees, of a square uint8 (B, H, H, C) batch -> float32.

    ``raw_scale`` keeps the raw 0-255 values (the reference feeds Visium
    patches unscaled); otherwise ``to_float`` scales them as the JAX
    function does. Data movement only, so it equals the JAX function bit
    for bit for the same draws.
    """
    b, h, w = patches_u8.shape[:3]
    if h != w:
        raise ValueError(f"tenx rotation needs square images, got {tuple(patches_u8.shape)}")
    imgs = patches_u8.float() if raw_scale else to_float(patches_u8)
    per_image = (b, 1, 1, 1)
    imgs = torch.where(draws.hflip.reshape(per_image), imgs.flip(2), imgs)
    imgs = torch.where(draws.vflip.reshape(per_image), imgs.flip(1), imgs)
    k = torch.tensor(TENX_QUARTER_TURNS, device=imgs.device)[draws.rot.long()].reshape(per_image)
    # The contiguous operand leads each torch.where, so the output keeps its
    # layout rather than a rot90 view's transposed strides (see
    # rotate_batch_paeth); .contiguous() then copies nothing.
    out = imgs
    for turns in (1, 2, 3):
        out = torch.where(k != turns, out, torch.rot90(imgs, turns, dims=(1, 2)))
    return out.contiguous()


def to_float(patches_u8: torch.Tensor) -> torch.Tensor:
    """Eval-time ToTensor: uint8 NHWC -> float32 [0, 1], as the JAX
    function computes it: XLA compiles its division by 255 into a
    multiplication by float32(1 / 255), which differs from the division in
    the last bit for about half of the values."""
    return patches_u8.float() * torch.tensor(1.0 / 255.0, dtype=torch.float32,
                                             device=patches_u8.device)
