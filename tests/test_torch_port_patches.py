"""Port parity of the patch gather: ``mclstexp_tpu_torch.ops.patches``
against the JAX package's three forms of the same crop.

The data layer of both packages cuts with ``extract_patches_np``, so the
port's plain version (and its kernel, held to it on the card) computes
exactly that for every center and every P, bit for bit. The JAX package's
other forms agree with it only in part, and the tests pin where:
  * ``ops/patches.extract_patches`` (XLA, a vmapped ``dynamic_slice`` over a
    slide padded by P) at even P for every center but those whose start
    c + r is negative and no further out than the padded size: jax's
    ``dynamic_slice`` wraps a negative start by the dimension before it
    clamps, so such a center reads slide pixels where the crop is zero;
  * the two Pallas kernels (TPU interpret mode) at even P for centers on the
    slide and its border; they pad only r + align, so centers far outside
    read slide pixels;
  * at odd P the three JAX forms disagree: ``extract_patches_np`` fills a box
    of 2r = P - 1 rows and columns (the last stays zero), the XLA and the
    Pallas forms take P from other origins.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mclstexp_tpu.ops.pallas_patches import extract_patches_pallas, extract_patches_pallas_bytes
from mclstexp_tpu.ops.patches import extract_patches as jax_extract_patches
from mclstexp_tpu.ops.patches import extract_patches_np as jax_extract_patches_np
from mclstexp_tpu_torch.ops import patches

torch.set_num_threads(1)

I32_MIN, I32_MAX = -2**31, 2**31 - 1
# Inside, on the border, just past it, far outside, and a missing spot's
# floor(NaN) (-2147483648), on a 60 x 80 slide.
ALL_CENTERS = np.array([[10, 12], [40, 30], [0, 0], [79, 59], [3, 57], [80, 60], [-5, 30],
                        [-200, 5], [500, 500], [40, -90], [I32_MIN, I32_MIN], [I32_MIN, 20],
                        [I32_MAX, I32_MAX]], dtype=np.int64)
ON_SLIDE = np.array([[10, 12], [40, 30], [0, 0], [79, 59], [3, 57], [70, 50], [41, 33]],
                    dtype=np.int32)


def _slide(rng, c, h=60, w=80):
    return rng.integers(0, 256, size=(h, w, c), dtype=np.uint8)


def _port_forms(slide, centers, p):
    """extract_patches_np, extract_patches_plain and the wrapper on the CPU."""
    t_slide, t_centers = torch.from_numpy(slide), torch.from_numpy(np.asarray(centers))
    return (patches.extract_patches_np(slide, centers, p),
            patches.extract_patches_plain(t_slide, t_centers, p).numpy(),
            patches.extract_patches(t_slide, t_centers, p).numpy())


@pytest.mark.parametrize("p", [8, 15, 16, 224])
@pytest.mark.parametrize("c", [1, 3, 4])
def test_port_forms_equal_jax_numpy_for_every_center(rng, c, p):
    """Every port form equals the JAX package's host cutter, bit for bit, at
    even, odd and the flagship P, for centers anywhere."""
    slide = _slide(rng, c)
    want = jax_extract_patches_np(slide, ALL_CENTERS, p)
    assert want.shape == (len(ALL_CENTERS), p, p, c)
    for got in _port_forms(slide, ALL_CENTERS, p):
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    assert not want[10:].any()  # the missing spots and the largest int32: all zero


WRAPS = 9  # (40, -90): at P = 16 its start -82 wraps into the 92-row padded slide


@pytest.mark.parametrize("p", [8, 16, 224])
def test_plain_equals_jax_xla_form_at_even_p(rng, p):
    slide = _slide(rng, 3)
    centers = np.delete(ALL_CENTERS, WRAPS, axis=0)
    want = np.asarray(jax_extract_patches(jnp.asarray(slide),
                                          jnp.asarray(centers.astype(np.int32)), p))
    got = patches.extract_patches_plain(torch.from_numpy(slide),
                                        torch.from_numpy(centers), p).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("c,p", [(3, 16), (1, 32), (4, 16)])
def test_plain_equals_jax_pallas_forms_on_the_slide(rng, c, p):
    """Both Pallas kernels in interpret mode, the pattern of
    tests/test_pallas_patches.py, on centers on the slide and its border."""
    slide = rng.integers(0, 255, size=(96, 130, c), dtype=np.uint8)
    centers = np.array([[10, 12], [127, 90], [41, 33], [3, 3], [64, 64], [0, 0], [129, 95]],
                       dtype=np.int32)
    got = patches.extract_patches_plain(torch.from_numpy(slide), torch.from_numpy(centers),
                                        p).numpy()
    for form in (extract_patches_pallas, extract_patches_pallas_bytes):
        want = np.asarray(form(jnp.asarray(slide), jnp.asarray(centers), p, interpret=True))
        np.testing.assert_array_equal(got, want, err_msg=f"{form.__name__} c={c} p={p}")


def test_jax_forms_disagree_at_odd_p_and_far_outside(rng):
    """Pinned: the JAX package's own forms differ (its loaders cut with
    extract_patches_np, which the port follows)."""
    slide = _slide(rng, 3)
    inside = ON_SLIDE[:2]
    np_form = jax_extract_patches_np(slide, inside, 15)
    xla = np.asarray(jax_extract_patches(jnp.asarray(slide), jnp.asarray(inside), 15))
    pallas = np.asarray(extract_patches_pallas(jnp.asarray(slide), jnp.asarray(inside), 15,
                                               interpret=True))
    assert not np.array_equal(np_form, xla)
    assert not np.array_equal(np_form, pallas)
    assert not np.array_equal(xla, pallas)
    assert not np_form[:, 14].any() and not np_form[:, :, 14].any()  # the box is 2r = 14 wide
    np.testing.assert_array_equal(_port_forms(slide, inside, 15)[1], np_form)

    far = np.array([[-200, 5], [500, 500]], dtype=np.int32)
    zeros = np.zeros((2, 16, 16, 3), np.uint8)
    np.testing.assert_array_equal(jax_extract_patches_np(slide, far, 16), zeros)
    np.testing.assert_array_equal(
        np.asarray(jax_extract_patches(jnp.asarray(slide), jnp.asarray(far), 16)), zeros)
    for form in (extract_patches_pallas, extract_patches_pallas_bytes):
        got = np.asarray(form(jnp.asarray(slide), jnp.asarray(far), 16, interpret=True))
        assert got.any(), form.__name__  # reads slide pixels where it should be zero

    above = ALL_CENTERS[WRAPS:WRAPS + 1].astype(np.int32)  # start -82 wraps to row 10
    xla = np.asarray(jax_extract_patches(jnp.asarray(slide), jnp.asarray(above), 16))
    assert not jax_extract_patches_np(slide, above, 16).any()
    np.testing.assert_array_equal(xla[0, 6:], slide[:10, 32:48])


def test_two_dimensional_slide_is_one_channel(rng):
    slide = _slide(rng, 1)
    flat = torch.from_numpy(slide[..., 0].copy())
    centers = torch.from_numpy(ALL_CENTERS)
    got = patches.extract_patches(flat, centers, 16)
    assert got.shape == (len(ALL_CENTERS), 16, 16, 1)
    np.testing.assert_array_equal(got.numpy(), jax_extract_patches_np(slide, ALL_CENTERS, 16))


def test_empty_centers_and_strided_slide(rng):
    slide = _slide(rng, 3)
    none = torch.zeros((0, 2), dtype=torch.int32)
    assert patches.extract_patches(torch.from_numpy(slide), none, 16).shape == (0, 16, 16, 3)
    # the plain version (the CPU path) takes any strides; the kernel wants contiguous
    view = torch.from_numpy(slide).transpose(0, 1)
    got = patches.extract_patches(view, torch.from_numpy(ON_SLIDE), 8)
    np.testing.assert_array_equal(
        got.numpy(), jax_extract_patches_np(np.ascontiguousarray(slide.transpose(1, 0, 2)),
                                            ON_SLIDE, 8))


def test_wrapper_rejects_what_the_kernel_does_not_take(rng):
    slide = torch.from_numpy(_slide(rng, 3))
    centers = torch.from_numpy(ON_SLIDE)
    before = patches.extract_patches.launches
    with pytest.raises(TypeError, match="uint8"):
        patches.extract_patches(slide.float(), centers, 8)
    with pytest.raises(TypeError, match="integer"):
        patches.extract_patches(slide, centers.float(), 8)
    with pytest.raises(ValueError, match=r"\(N, 2\)"):
        patches.extract_patches(slide, centers[:, :1], 8)
    with pytest.raises(ValueError, match="slide"):
        patches.extract_patches(slide[None], centers, 8)
    with pytest.raises(ValueError, match="patch_size"):
        patches.extract_patches(slide, centers, 0)
    patches.extract_patches(slide, centers, 8)
    assert patches.extract_patches.launches == before  # the CPU path launches nothing
