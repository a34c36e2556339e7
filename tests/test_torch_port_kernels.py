"""The port's CUDA kernels against their plain versions on the card.

These tests need an NVIDIA card (a CUDA kernel has no CPU mode) and skip
without one. On the card:

    python -m pytest tests/test_torch_port_kernels.py -m gpu
"""

import pytest
import torch

from mclstexp_tpu_torch.ops import augment
from mclstexp_tpu_torch.ops.row_shift import row_shift, row_shift_plain

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_row_shift_kernel_matches_plain(cuda, dtype):
    """Bit-equal in both layouts, clamp edges included; one launch each."""
    x = torch.rand((4, 32, 40, 3), generator=cuda, device="cuda").to(dtype)
    k = torch.randint(-50, 51, (4, 32), generator=cuda, device="cuda", dtype=torch.int32)
    k[0, :6] = torch.tensor([0, 20, -20, 21, -21, 200])
    before = row_shift.launches
    got = row_shift(x, k)
    torch.testing.assert_close(got, row_shift_plain(x, k), rtol=0, atol=0)
    xt = torch.rand((4, 40, 32, 3), generator=cuda, device="cuda").to(dtype).transpose(1, 2)
    got_t = row_shift(xt, k)
    assert got_t.stride() == xt.stride()
    torch.testing.assert_close(got_t, row_shift_plain(xt, k), rtol=0, atol=0)
    assert row_shift.launches == before + 2


@pytest.mark.gpu
def test_row_shift_kernel_rejects_other_layouts(cuda):
    x = torch.rand((2, 8, 8, 3), generator=cuda, device="cuda")
    k = torch.zeros((2, 8), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="transpose"):
        row_shift(x[:, :, ::2], k)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        row_shift(x.half(), k)


@pytest.mark.gpu
def test_paeth_rotation_on_card_matches_cpu(cuda):
    """Three kernel launches on the card give the CPU's plain rotation for
    the same shears (angles that are multiples of 90, and small ones whose
    shears are integers on both devices): two launches in the row layout,
    one in the column layout."""
    imgs = torch.rand((6, 16, 16, 3), generator=cuda, device="cuda")
    angles = torch.tensor([0.0, 90.0, 180.0, -90.0, 270.0, 0.0], device="cuda")
    hflip = torch.tensor([True, False, True, False, True, True], device="cuda")
    before, layouts = row_shift.launches, dict(row_shift.layout_launches)
    got = augment.rotate_batch_paeth(imgs, angles, hflip)
    assert row_shift.launches == before + 3
    assert row_shift.layout_launches == {"rows": layouts["rows"] + 2, "cols": layouts["cols"] + 1}
    want = augment.rotate_batch_paeth(imgs.cpu(), angles.cpu(), hflip.cpu())
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)
