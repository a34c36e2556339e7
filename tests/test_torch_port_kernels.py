"""The port's CUDA kernels against their plain versions on the card.

These tests need an NVIDIA card (a CUDA kernel has no CPU mode) and skip
without one. On the card:

    python -m pytest tests/test_torch_port_kernels.py -m gpu
"""

import pytest
import torch

from mclstexp_tpu_torch.core.layers import MultiHeadSelfAttention
from mclstexp_tpu_torch.ops import augment
from mclstexp_tpu_torch.ops.flash_attention import attention_plain, flash_attention
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


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 32, 128, 300])
@pytest.mark.parametrize("d", [16, 64, 128])
def test_flash_attention_kernel_matches_plain(cuda, n, d):
    """fp32 against the plain softmax path, the tail tile masked (n not a
    multiple of 32); atol 2e-5 (fp32 sums in another order and exp against
    the softmax's exp). One launch per call."""
    q, k, v = (torch.randn((2, 8, n, d), generator=cuda, device="cuda") for _ in range(3))
    before = flash_attention.launches
    got = flash_attention(q, k, v, d**-0.5)
    assert flash_attention.launches == before + 1
    torch.cuda.synchronize()
    torch.testing.assert_close(got, attention_plain(q, k, v, d**-0.5), rtol=0, atol=2e-5)


@pytest.mark.gpu
def test_flash_attention_reads_the_qkv_buffer_in_place(cuda):
    """The (b, n, 3, h, d) buffer of the qkv projection, read through the
    strides of its three (b, h, n, d) views; the output is the (b, h, n, d)
    view of a contiguous (b, n, h, d) buffer."""
    qkv = torch.randn((1, 300, 3, 8, 64), generator=cuda, device="cuda")
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    got = flash_attention(q, k, v, 0.125)
    assert got.transpose(1, 2).is_contiguous()
    want = attention_plain(q.contiguous(), k.contiguous(), v.contiguous(), 0.125)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)


@pytest.mark.gpu
def test_flash_attention_raises_for_mask_grad_and_shape(cuda):
    q = torch.randn((1, 2, 32, 16), generator=cuda, device="cuda")
    with pytest.raises(NotImplementedError, match="key mask"):
        flash_attention(q, q, q, 0.25, torch.ones(32, dtype=torch.bool, device="cuda"))
    qg = q.clone().requires_grad_()
    with pytest.raises(NotImplementedError, match="backward"):
        flash_attention(qg, qg, qg, 0.25)
    with torch.no_grad():
        flash_attention(qg, qg, qg, 0.25)  # no gradient wanted: the kernel runs
    with pytest.raises(ValueError, match="d <= 128"):
        x = torch.zeros((1, 1, 4, 160), device="cuda")
        flash_attention(x, x, x, 1.0)
    with pytest.raises(TypeError, match="float32"):
        flash_attention(q.half(), q.half(), q.half(), 0.25)


@pytest.mark.gpu
def test_flash_module_on_card_matches_xla_module(cuda):
    """MultiHeadSelfAttention(backend="flash") on the card equals the "xla"
    module with the same weights, and launches the kernel once."""
    torch.manual_seed(0)
    xla = MultiHeadSelfAttention(785, heads=8, dim_head=64, device="cuda", backend="xla")
    flash = MultiHeadSelfAttention(785, heads=8, dim_head=64, device="cuda", backend="flash")
    flash.load_state_dict(xla.state_dict())
    x = torch.randn((1, 32, 785), generator=cuda, device="cuda")
    before = flash_attention.launches
    with torch.no_grad():
        got, want = flash(x), xla(x)
    assert flash_attention.launches == before + 1
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
