"""Port parity: the row_shift kernel's plain version and the "st" and "tenx"
augmentations.

Inputs are made by numpy from a seed and go through both packages; the JAX
side runs its Pallas kernel in interpret mode on the CPU. Data movement
(rotations, flips, "tenx" and its 0-255 or [0, 1] scale) is held exact; the
jitter arithmetic to atol 1e-6 (the two frameworks may sum the per-image
gray mean in another order, ~1 ulp at [0, 1]).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mclstexp_tpu.ops import augment as jax_augment
from mclstexp_tpu.ops.pallas_shift import row_shift as jax_row_shift
from mclstexp_tpu_torch.ops import augment
from mclstexp_tpu_torch.ops.row_shift import row_shift, row_shift_plain

torch.set_num_threads(1)


def _shifts_with_clamp_edges(rng, b, h, w):
    """Random shifts that include 0, +-W//2 and values beyond the clamp."""
    s = rng.integers(-w, w + 1, size=(b, h)).astype(np.int32)
    edges = np.array([0, w // 2, -(w // 2), w // 2 + 1, -(w // 2) - 1, w, -w, 3 * w])
    s.reshape(-1)[: len(edges)] = edges
    return s


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_row_shift_plain_matches_jax(rng, dtype):
    x = rng.uniform(size=(3, 16, 16, 3)).astype(np.float32)
    shifts = _shifts_with_clamp_edges(rng, 3, 16, 16)
    jx = jnp.asarray(x).astype(dtype)
    want = np.asarray(jax_row_shift(jx, jnp.asarray(shifts), interpret=True).astype(jnp.float32))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = row_shift(tx, torch.from_numpy(shifts))
    assert got.dtype == tx.dtype
    np.testing.assert_array_equal(got.float().numpy(), want)
    np.testing.assert_array_equal(row_shift_plain(tx, torch.from_numpy(shifts)).float().numpy(),
                                  want)


def test_row_shift_column_view_matches_jax_transpose(rng):
    """A transposed view shifts its rows like JAX's swapaxes round trip (the
    Paeth column shear), and the output keeps the view's strides."""
    x = rng.uniform(size=(2, 16, 16, 3)).astype(np.float32)
    shifts = _shifts_with_clamp_edges(rng, 2, 16, 16)
    want = np.asarray(jnp.swapaxes(
        jax_row_shift(jnp.swapaxes(jnp.asarray(x), 1, 2), jnp.asarray(shifts), interpret=True),
        1, 2))
    got = row_shift(torch.from_numpy(x).transpose(1, 2), torch.from_numpy(shifts)).transpose(1, 2)
    np.testing.assert_array_equal(got.numpy(), want)


def test_row_shift_rejects_bad_inputs():
    x = torch.zeros(2, 8, 8, 3)
    with pytest.raises(ValueError, match="shifts must be"):
        row_shift(x, torch.zeros(2, 7, dtype=torch.int32))
    with pytest.raises(TypeError, match="integer"):
        row_shift(x, torch.zeros(2, 8))
    with pytest.raises(ValueError, match=r"\(B, H, W, C\)"):
        row_shift(x[0], torch.zeros(8, dtype=torch.int32))


def _jax_st_draws(key, b):
    """The draws jax train_augment_inline takes from `key` (its splits)."""
    k_jit, k_flip, k_rot = jax.random.split(key, 3)
    jitter, order = [], []
    for k in jax.random.split(k_jit, b):
        k_perm, k_b, k_c, k_s = jax.random.split(k, 4)
        jitter.append([float(jax.random.uniform(kk, (), minval=0.5, maxval=1.5))
                       for kk in (k_b, k_c, k_s)])
        order.append(int(jax.random.randint(k_perm, (), 0, 6)))
    return augment.StDraws(
        jitter=torch.tensor(np.asarray(jitter, np.float32)),
        order=torch.tensor(order),
        hflip=torch.from_numpy(np.array(jax.random.bernoulli(k_flip, 0.5, (b,)))),
        angles=torch.from_numpy(np.array(
            jax.random.uniform(k_rot, (b,), minval=-180.0, maxval=180.0))),
    )


def _jax_tenx_draws(key, b):
    """The draws jax tenx_augment_inline takes from `key` (its splits)."""
    k_h, k_v, k_r = jax.random.split(key, 3)
    return augment.TenxDraws(
        hflip=torch.from_numpy(np.array(jax.random.bernoulli(k_h, 0.5, (b,)))),
        vflip=torch.from_numpy(np.array(jax.random.bernoulli(k_v, 0.5, (b,)))),
        rot=torch.from_numpy(np.array(jax.random.randint(k_r, (b,), 0, 4))),
    )


def _shears_agree(angles):
    """Both frameworks' float32 trig must round every shear alike, the tan
    row shear and the -sin column shear; the test angles are checked here
    rather than trusted."""
    k90 = jnp.round(angles / 90.0)
    theta = (angles - k90 * 90.0) * (jnp.pi / 180.0)
    c = jnp.arange(16, dtype=jnp.float32) - 7.5
    t, tc = torch.from_numpy(np.array(theta)), torch.from_numpy(np.array(c))
    shear_x = (np.asarray(jnp.round(jnp.tan(theta / 2.0)[:, None] * c)),
               torch.round(torch.tan(t / 2.0)[:, None] * tc).numpy())
    shear_y = (np.asarray(jnp.round(-jnp.sin(theta)[:, None] * c)),
               torch.round(-torch.sin(t)[:, None] * tc).numpy())
    return all(np.array_equal(j, p) for j, p in (shear_x, shear_y))


@pytest.mark.parametrize("with_flip", [False, True])
def test_rotate_batch_paeth_matches_jax(rng, with_flip):
    imgs = rng.uniform(size=(6, 16, 16, 3)).astype(np.float32)
    angles = np.concatenate([[0.0, 90.0, -135.0], rng.uniform(-180, 180, size=3)]).astype(
        np.float32)
    hflip = np.array([True, False, True, True, False, True]) if with_flip else None
    assert _shears_agree(jnp.asarray(angles))
    want = np.asarray(jax_augment.rotate_batch_paeth(
        jnp.asarray(imgs), jnp.asarray(angles),
        hflip=None if hflip is None else jnp.asarray(hflip), interpret=True))
    got = augment.rotate_batch_paeth(
        torch.from_numpy(imgs), torch.from_numpy(angles),
        hflip=None if hflip is None else torch.from_numpy(hflip))
    np.testing.assert_array_equal(got.numpy(), want)


def test_rotate_batch_paeth_shear_layouts(monkeypatch):
    """Every quarter turn gives the row shears a contiguous image and the
    column shear its transposed view, the layouts the kernel's row and
    column modes take."""
    layouts = []

    def record(imgs, shifts):
        layouts.append("rows" if imgs.is_contiguous() else
                       "cols" if imgs.transpose(1, 2).is_contiguous() else "other")
        return row_shift(imgs, shifts)

    monkeypatch.setattr(augment, "row_shift", record)
    imgs = torch.rand(4, 8, 8, 3, generator=torch.Generator().manual_seed(0))
    for angle in (10.0, 100.0, 190.0, -80.0):
        layouts.clear()
        augment.rotate_batch_paeth(imgs, torch.full((4,), angle),
                                   hflip=torch.tensor([True, False, True, False]))
        assert layouts == ["rows", "cols", "rows"], angle
    layouts.clear()
    augment.rotate_batch_paeth(imgs, torch.tensor([10.0, 100.0, 190.0, -80.0]))
    assert layouts == ["rows", "cols", "rows"]


def test_rotate_batch_matches_jax(rng):
    imgs = rng.uniform(size=(5, 12, 12, 3)).astype(np.float32)
    angles = np.array([0.0, 90.0, 33.0, -71.0, 158.0], np.float32)
    hflip = np.array([True, False, True, True, False])
    want = np.asarray(jax_augment.rotate_batch(jnp.asarray(imgs), jnp.asarray(angles),
                                               hflip=jnp.asarray(hflip)))
    got = augment.rotate_batch(torch.from_numpy(imgs), torch.from_numpy(angles),
                               hflip=torch.from_numpy(hflip))
    np.testing.assert_array_equal(got.numpy(), want)


def test_color_jitter_matches_jax_per_image_order(rng):
    """Every one of the six op orders, each image its own factors."""
    imgs = rng.uniform(size=(6, 8, 8, 3)).astype(np.float32)
    factors = rng.uniform(0.5, 1.5, size=(6, 3)).astype(np.float32)
    order = np.arange(6)
    want = []
    for i in range(6):
        fb, fc, fs = (jnp.asarray(f) for f in factors[i])
        ops = jax_augment._jitter_ops_cm(fb, fc, fs)
        x = jnp.moveaxis(jnp.asarray(imgs[i]), -1, 0)
        for j in jax_augment._PERMS[order[i]]:
            x = ops[j](x)
        want.append(np.asarray(jnp.moveaxis(x, 0, -1)))
    got = augment.color_jitter(torch.from_numpy(imgs), torch.from_numpy(factors),
                               torch.from_numpy(order))
    np.testing.assert_allclose(got.numpy(), np.stack(want), rtol=0, atol=1e-6)


def test_train_augment_inline_matches_jax(rng):
    """The whole "st" augmentation from the draws the JAX step's key gives."""
    patches = rng.integers(0, 256, size=(8, 16, 16, 3), dtype=np.uint8)
    aug_key, _ = jax.random.split(jax.random.PRNGKey(3))  # step.py's split
    want = np.asarray(jax_augment.train_augment_inline(
        aug_key, jnp.asarray(patches), dtype=jnp.float32, rot_impl="paeth"))
    draws = _jax_st_draws(aug_key, 8)
    assert _shears_agree(jnp.asarray(draws.angles.numpy()))
    got = augment.train_augment_inline(torch.from_numpy(patches), draws)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def _every_uint8(shape):
    """A uint8 batch that holds each of the 256 values, tiled to ``shape``."""
    return np.resize(np.arange(256, dtype=np.uint8), shape)


def test_train_augment_inline_scales_like_the_jitted_jax_step(monkeypatch):
    """The float32 input that reaches ``color_jitter`` is bit-equal, for all
    256 uint8 values, to the JAX step's ``/ 255`` as XLA compiles it (a
    multiplication by float32(1/255); a true division differs for 126 of
    them)."""
    patches = _every_uint8((2, 16, 16, 3))
    seen = []

    def jitter(imgs, factors, order):
        seen.append(imgs.clone())
        return imgs

    monkeypatch.setattr(augment, "color_jitter", jitter)
    draws = augment.sample_st_draws(torch.Generator().manual_seed(0), 2, "cpu")
    augment.train_augment_inline(torch.from_numpy(patches), draws)
    want = np.asarray(jax.jit(lambda u: u.astype(jnp.float32) / 255.0)(jnp.asarray(patches)))
    assert len(seen) == 1 and seen[0].dtype == torch.float32
    np.testing.assert_array_equal(seen[0].numpy(), want)
    assert (torch.from_numpy(patches).float() / 255.0 != seen[0]).any()  # the fault it repairs


@pytest.mark.parametrize("raw_scale", [False, True])
def test_tenx_augment_matches_jax_in_every_combination(rng, raw_scale):
    """Bit-equal to the JAX function for the draws derived from its key,
    over a batch whose draws hold all 16 flip/rotation combinations; each
    image also equals the numpy flips and rotation its draws name."""
    patches = rng.integers(0, 256, size=(128, 12, 12, 3), dtype=np.uint8)
    key = jax.random.PRNGKey(5)
    want = np.asarray(jax_augment.tenx_augment(key, jnp.asarray(patches), raw_scale=raw_scale))
    draws = _jax_tenx_draws(key, 128)
    combos = list(zip(draws.hflip.tolist(), draws.vflip.tolist(), draws.rot.tolist()))
    assert len(set(combos)) == 16
    got = augment.tenx_augment(torch.from_numpy(patches), draws, raw_scale)
    assert got.dtype == torch.float32 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)

    scale = np.float32(1.0) if raw_scale else np.float32(1.0 / 255.0)
    for (h, v, r), im, out in zip(combos, patches.astype(np.float32) * scale, want):
        im = im[:, ::-1] if h else im
        im = im[::-1] if v else im
        np.testing.assert_array_equal(out, np.rot90(im, k=augment.TENX_QUARTER_TURNS[r]))


def test_tenx_augment_rejects_non_square():
    draws = augment.sample_tenx_draws(torch.Generator().manual_seed(0), 2, "cpu")
    with pytest.raises(ValueError, match="square"):
        augment.tenx_augment(torch.zeros((2, 8, 6, 3), dtype=torch.uint8), draws)


def test_to_float_matches_jax(rng):
    patches = rng.integers(0, 256, size=(4, 8, 8, 3), dtype=np.uint8)
    np.testing.assert_array_equal(augment.to_float(torch.from_numpy(patches)).numpy(),
                                  np.asarray(jax_augment.to_float(jnp.asarray(patches))))


def test_sample_tenx_draws_ranges_and_reseed():
    g = torch.Generator().manual_seed(0)
    d = augment.sample_tenx_draws(g, 512, "cpu")
    assert d.hflip.dtype == d.vflip.dtype == torch.bool
    assert set(d.rot.tolist()) == {0, 1, 2, 3}
    assert 0.35 < float(d.hflip.float().mean()) < 0.65
    assert 0.35 < float(d.vflip.float().mean()) < 0.65
    # keyed draws depend on the key only, not on what was drawn before
    a = augment.sample_tenx_draws(augment.reseed(g, 7, 1, 2), 64, "cpu")
    augment.sample_st_draws(g, 99, "cpu")
    b = augment.sample_tenx_draws(augment.reseed(g, 7, 1, 2), 64, "cpu")
    c = augment.sample_tenx_draws(augment.reseed(g, 7, 2, 1), 64, "cpu")
    assert torch.equal(a.rot, b.rot) and torch.equal(a.hflip, b.hflip)
    assert not torch.equal(a.rot, c.rot)


def test_sample_st_draws_ranges():
    g = torch.Generator().manual_seed(0)
    d = augment.sample_st_draws(g, 512, "cpu")
    assert d.jitter.shape == (512, 3) and d.order.shape == (512,)
    assert 0.5 <= float(d.jitter.min()) and float(d.jitter.max()) < 1.5
    assert set(d.order.tolist()) == set(range(6))
    assert 0.35 < float(d.hflip.float().mean()) < 0.65
    assert -180 <= float(d.angles.min()) and float(d.angles.max()) < 180
