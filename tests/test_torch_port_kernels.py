"""The port's CUDA kernels against their plain versions on the card.

These tests need an NVIDIA card (a CUDA kernel has no CPU mode) and skip
without one. On the card:

    python -m pytest --noconftest tests/test_torch_port_kernels.py -m gpu

The patch gather is bit-equal to its plain version (a byte copy).
Flash-attention tolerances: atol 2e-5 for the forward and both backward
kernels against their plain versions, the forward's l relative (fp32 on
both sides; sums in another order, the forward's online softmax rescaling,
and the kernels' 3xTF32 tensor-core products, which keep fp32 accuracy; the
plain versions are within ~2e-6 of float64 at these shapes). The flash
kernels are deterministic: the cluster ranks' partials are merged in a
fixed order.
"""

import pytest
import torch

from mclstexp_tpu_torch.core.layers import MultiHeadSelfAttention
from mclstexp_tpu_torch.ops import augment
from mclstexp_tpu_torch.ops import flash_attention as fa
from mclstexp_tpu_torch.ops.flash_attention import attention_plain, flash_attention
from mclstexp_tpu_torch.ops.patches import extract_patches, extract_patches_plain
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


def _qkv(cuda, b, h, n, d, strided):
    """q, k, v: three (b, h, n, d) tensors, or the views of one (b, n, 3, h,
    d) qkv buffer when ``strided``."""
    if strided:
        qkv = torch.randn((b, n, 3, h, d), generator=cuda, device="cuda")
        return tuple(qkv[:, :, i].transpose(1, 2) for i in range(3))
    return tuple(torch.randn((b, h, n, d), generator=cuda, device="cuda") for _ in range(3))


def _check_forward(q, k, v, scale):
    """The forward kernel without residuals against attention_plain, and
    with them against flash_forward_plain: out and m to atol 2e-5, l
    relative; one launch each."""
    before = flash_attention.launches
    got = flash_attention(q, k, v, scale)
    out, l, m = fa.flash_forward(q, k, v, scale, residuals=True)
    assert flash_attention.launches == before + 2
    torch.cuda.synchronize()
    torch.testing.assert_close(got, attention_plain(q, k, v, scale), rtol=0, atol=2e-5)
    want, want_l, want_m = fa.flash_forward_plain(q, k, v, scale)
    torch.testing.assert_close(out, want, rtol=0, atol=2e-5)
    torch.testing.assert_close(m, want_m, rtol=0, atol=2e-5)
    torch.testing.assert_close(l, want_l, rtol=2e-5, atol=0)
    return got, out, l, m


@pytest.mark.gpu
@pytest.mark.parametrize("strided", [False, True], ids=["contiguous", "qkv_views"])
@pytest.mark.parametrize("n", [1, 32, 66, 128, 300, 1000])
@pytest.mark.parametrize("d", [16, 64, 128])
def test_flash_attention_kernel_matches_plain(cuda, n, d, strided):
    """fp32 against the plain versions, with and without residuals, the
    tail tile masked (n not a multiple of 32) and every plan of the cluster
    split (1, 32: split 1; 66: 3; 128: 4; 300: 2; 1000: 1 at b * h = 16);
    atol 2e-5 (fp32 sums in another order, the online softmax's rescaling,
    3xTF32 products)."""
    _check_forward(*_qkv(cuda, 2, 8, n, d, strided), d**-0.5)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [128, 300])
def test_flash_forward_unaligned_inputs_and_determinism(cuda, n):
    """q, k, v one float off a 16-byte boundary (the 4-byte staging path)
    within 2e-5 of the plain versions; and the same bits from run to run
    (the cluster merges in a fixed order), on the views of a qkv buffer."""
    _check_forward(*_offset_views(cuda, 1, 8, n, 64), 0.125)
    q, k, v = _qkv(cuda, 1, 8, n, 64, True)
    first = (flash_attention(q, k, v, 0.125), *fa.flash_forward(q, k, v, 0.125, residuals=True))
    second = (flash_attention(q, k, v, 0.125), *fa.flash_forward(q, k, v, 0.125, residuals=True))
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_flash_forward_refused_launch_raises(cuda, monkeypatch):
    """A plan the kernel refuses (a split of 9, past the portable cluster
    size) comes back as a CUDA error and raises; nothing is counted."""
    q, k, v = _qkv(cuda, 1, 8, 300, 64, True)
    monkeypatch.setattr(fa, "cluster_plan", lambda b, h, n, d: (32, 9, b * h * 10 * 9))
    before = flash_attention.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        flash_attention(q, k, v, 0.125)
    with pytest.raises(RuntimeError, match="CUDA error"):
        fa.flash_forward(q, k, v, 0.125, residuals=True)
    assert flash_attention.launches == before


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
    """A gradient now runs (the backward kernels), a key mask still raises."""
    q = torch.randn((1, 2, 32, 16), generator=cuda, device="cuda")
    with pytest.raises(NotImplementedError, match="key mask"):
        flash_attention(q, q, q, 0.25, torch.ones(32, dtype=torch.bool, device="cuda"))
    qg = q.clone().requires_grad_()
    before = (flash_attention.launches, fa.flash_bwd_dkv.launches, fa.flash_bwd_dq.launches)
    (g,) = torch.autograd.grad(flash_attention(qg, qg, qg, 0.25).sum(), qg)
    assert torch.isfinite(g).all()
    assert (flash_attention.launches, fa.flash_bwd_dkv.launches,
            fa.flash_bwd_dq.launches) == tuple(c + 1 for c in before)
    with pytest.raises(NotImplementedError, match="key mask"):
        flash_attention(qg, qg, qg, 0.25, torch.ones(32, dtype=torch.bool, device="cuda"))
    with torch.no_grad():
        flash_attention(qg, qg, qg, 0.25)  # no gradient wanted: the forward alone runs
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


FLASH_ATOL = 2e-5


def _bwd_inputs(cuda, n, d, strided):
    """q, k, v (as views of one (b, n, 3, h, d) qkv buffer when strided),
    dout, and the forward's out, l, m and di from the plain version."""
    if strided:
        qkv = torch.randn((2, n, 3, 4, d), generator=cuda, device="cuda")
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    else:
        q, k, v = (torch.randn((2, 4, n, d), generator=cuda, device="cuda") for _ in range(3))
    do = torch.randn((2, 4, n, d), generator=cuda, device="cuda")
    out, l, m = fa.flash_forward_plain(q, k, v, d**-0.5)
    return q, k, v, do, out, l, m, (out * do).sum(-1).contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("strided", [False, True], ids=["contiguous", "qkv_views"])
@pytest.mark.parametrize("n", [1, 32, 66, 128, 300])
@pytest.mark.parametrize("d", [16, 64, 128])
def test_flash_backward_kernels_match_plain(cuda, n, d, strided):
    """dK/dV and dQ against their plain versions from the same l, m, di;
    the forward's residuals against the plain l and m. One launch each."""
    q, k, v, do, out, l, m, di = _bwd_inputs(cuda, n, d, strided)
    scale = d**-0.5
    before = (fa.flash_bwd_dkv.launches, fa.flash_bwd_dq.launches)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, l, m, di, scale)
    dq = fa.flash_bwd_dq(q, k, v, do, l, m, di, scale)
    assert (fa.flash_bwd_dkv.launches, fa.flash_bwd_dq.launches) == (before[0] + 1,
                                                                     before[1] + 1)
    torch.cuda.synchronize()
    want_dk, want_dv = fa.flash_bwd_dkv_plain(q, k, v, do, l, m, di, scale)
    for got, want in ((dk, want_dk), (dv, want_dv), (dq, fa.flash_bwd_dq_plain(
            q, k, v, do, l, m, di, scale))):
        torch.testing.assert_close(got, want, rtol=0, atol=FLASH_ATOL)
    kout, kl, km = fa.flash_forward(q, k, v, scale, residuals=True)
    torch.testing.assert_close(kout, out, rtol=0, atol=FLASH_ATOL)
    torch.testing.assert_close(km, m, rtol=0, atol=FLASH_ATOL)
    torch.testing.assert_close(kl, l, rtol=1e-5, atol=FLASH_ATOL)


def _offset_views(cuda, b, h, n, d):
    """q, k, v whose data start one float past a 16-byte boundary, so the
    kernels stage them with 4-byte copies."""
    buf = torch.randn(3 * b * h * n * d + 1, generator=cuda, device="cuda")
    size = b * h * n * d
    views = [buf[1 + i * size:1 + (i + 1) * size].view(b, h, n, d) for i in range(3)]
    assert all(t.data_ptr() % 16 == 4 for t in views)
    return views


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["n1000_split5", "offset_n128", "offset_n300"])
def test_flash_backward_cluster_split_and_unaligned_inputs(cuda, case):
    """(1, 1, 1000, 64): the plan splits each walk 5 ways, each rank walks
    6-7 tiles with a ragged last tile of 8 rows. q, k, v one float off a
    16-byte boundary at n = 128 and 300: the 4-byte staging path. Both
    kernels within 2e-5 of their plain versions, one launch each."""
    if case == "n1000_split5":
        b, h, n, d = 1, 1, 1000, 64
        assert fa.cluster_plan(b, h, n, d) == (32, 5, 160)
        q, k, v = (torch.randn((b, h, n, d), generator=cuda, device="cuda") for _ in range(3))
    else:
        b, h, n, d = 1, 8, int(case.split("n")[-1]), 64
        q, k, v = _offset_views(cuda, b, h, n, d)
    do = torch.randn((b, h, n, d), generator=cuda, device="cuda")
    out, l, m = fa.flash_forward_plain(q, k, v, d**-0.5)
    di = (out * do).sum(-1).contiguous()
    args = (q, k, v, do, l, m, di, d**-0.5)
    before = (fa.flash_bwd_dkv.launches, fa.flash_bwd_dq.launches)
    dk, dv = fa.flash_bwd_dkv(*args)
    dq = fa.flash_bwd_dq(*args)
    assert (fa.flash_bwd_dkv.launches, fa.flash_bwd_dq.launches) == (before[0] + 1,
                                                                     before[1] + 1)
    torch.cuda.synchronize()
    want_dk, want_dv = fa.flash_bwd_dkv_plain(*args)
    for got, want in ((dk, want_dk), (dv, want_dv), (dq, fa.flash_bwd_dq_plain(*args))):
        torch.testing.assert_close(got, want, rtol=0, atol=FLASH_ATOL)


@pytest.mark.gpu
def test_flash_backward_refused_launch_raises(cuda, monkeypatch):
    """A plan the kernels refuse (a split of 9, past the portable cluster
    size) comes back as a CUDA error and raises; nothing is counted."""
    q, k, v, do, _, l, m, di = _bwd_inputs(cuda, 300, 64, True)
    monkeypatch.setattr(fa, "cluster_plan", lambda b, h, n, d: (32, 9, b * h * 10 * 9))
    before = (fa.flash_bwd_dkv.launches, fa.flash_bwd_dq.launches)
    with pytest.raises(RuntimeError, match="CUDA error"):
        fa.flash_bwd_dkv(q, k, v, do, l, m, di, 0.125)
    with pytest.raises(RuntimeError, match="CUDA error"):
        fa.flash_bwd_dq(q, k, v, do, l, m, di, 0.125)
    assert (fa.flash_bwd_dkv.launches, fa.flash_bwd_dq.launches) == before


@pytest.mark.gpu
@pytest.mark.parametrize("n", [128, 300])
def test_flash_backward_is_deterministic(cuda, n):
    """No atomics: the cluster's partial sums are added in rank order, so
    two runs give the same bits; at the training shape (1, 8, 128, 64) the
    plan splits each walk 4 ways over 128 CTAs, at n = 300 2 ways."""
    rows, split, ctas = fa.cluster_plan(1, 8, n, 64)
    if n == 128:
        assert split == 4 and ctas >= 128
    qkv = torch.randn((1, n, 3, 8, 64), generator=cuda, device="cuda")
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    do = torch.randn((1, 8, n, 64), generator=cuda, device="cuda")
    out, l, m = fa.flash_forward_plain(q, k, v, 0.125)
    di = (out * do).sum(-1).contiguous()
    first = (*fa.flash_bwd_dkv(q, k, v, do, l, m, di, 0.125),
             fa.flash_bwd_dq(q, k, v, do, l, m, di, 0.125))
    second = (*fa.flash_bwd_dkv(q, k, v, do, l, m, di, 0.125),
              fa.flash_bwd_dq(q, k, v, do, l, m, di, 0.125))
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [66, 128])
def test_flash_autograd_matches_plain_autograd(cuda, n):
    """torch.autograd.grad through the Function (forward with residuals,
    dK/dV, dQ: one launch each) against autograd of the plain path, on the
    views of one qkv buffer, into which autograd adds the three gradients."""
    qkv = torch.randn((1, n, 3, 8, 64), generator=cuda, device="cuda", requires_grad=True)
    cot = torch.randn((1, 8, n, 64), generator=cuda, device="cuda")

    def grad(attend):
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        return torch.autograd.grad((attend(q, k, v, 0.125) * cot).sum(), qkv)[0]

    counts = lambda: (flash_attention.launches, fa.flash_bwd_dkv.launches,  # noqa: E731
                      fa.flash_bwd_dq.launches)
    before = counts()
    got = grad(flash_attention)
    assert counts() == tuple(c + 1 for c in before)
    torch.testing.assert_close(got, grad(attention_plain), rtol=0, atol=FLASH_ATOL)


@pytest.mark.gpu
def test_flash_module_trains_like_xla_module(cuda):
    """MultiHeadSelfAttention(backend="flash") at the training shape: the
    parameter and input gradients of the "xla" module with the same weights."""
    torch.manual_seed(0)
    xla = MultiHeadSelfAttention(785, heads=8, dim_head=64, device="cuda", backend="xla")
    flash = MultiHeadSelfAttention(785, heads=8, dim_head=64, device="cuda", backend="flash")
    flash.load_state_dict(xla.state_dict())
    x = torch.randn((1, 128, 785), generator=cuda, device="cuda")
    grads = []
    for mod in (flash, xla):
        xx = x.clone().requires_grad_()
        mod(xx).square().sum().backward()
        grads.append([xx.grad] + [p.grad for p in mod.parameters()])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


PATCH_CENTERS = ((10, 12), (40, 30), (0, 0), (79, 59), (80, 60), (-5, 30), (-200, 5),
                 (500, 500), (40, -90), (-2**31, -2**31), (-2**31, 20), (2**31 - 1, 7))


@pytest.mark.gpu
@pytest.mark.parametrize("p", [15, 16, 32, 224])
@pytest.mark.parametrize("c", [1, 3, 4])
def test_extract_patches_kernel_matches_plain(cuda, c, p):
    """Centers inside, on the border, far outside and a missing spot's
    floor(NaN) (-2147483648), on a 60 x 80 slide: bit-equal, one launch, and
    two runs bit-equal."""
    slide = torch.randint(0, 256, (60, 80, c), generator=cuda, device="cuda",
                          dtype=torch.int32).to(torch.uint8)
    centers = torch.tensor(PATCH_CENTERS, device="cuda")
    before = extract_patches.launches
    got = extract_patches(slide, centers, p)
    assert extract_patches.launches == before + 1
    assert got.shape == (len(PATCH_CENTERS), p, p, c) and got.dtype == torch.uint8
    assert torch.equal(got, extract_patches_plain(slide, centers, p))
    assert torch.equal(got, extract_patches(slide, centers, p))


@pytest.mark.gpu
def test_extract_patches_kernel_edges(cuda):
    """N = 0 returns an empty tensor without a launch; an (H, W) slide is one
    channel; a non-uint8 or non-contiguous slide raises."""
    slide = torch.randint(0, 256, (60, 80, 3), generator=cuda, device="cuda",
                          dtype=torch.int32).to(torch.uint8)
    centers = torch.tensor(PATCH_CENTERS, device="cuda", dtype=torch.int32)
    before = extract_patches.launches
    empty = extract_patches(slide, centers[:0], 16)
    assert empty.shape == (0, 16, 16, 3) and extract_patches.launches == before
    flat = slide[..., 0].contiguous()
    assert torch.equal(extract_patches(flat, centers, 16),
                       extract_patches_plain(flat, centers, 16))
    with pytest.raises(TypeError, match="uint8"):
        extract_patches(slide.float(), centers, 16)
    with pytest.raises(ValueError, match="contiguous"):
        extract_patches(slide.transpose(0, 1), centers, 16)
    with pytest.raises(ValueError, match="on cpu"):
        extract_patches(slide, centers.cpu(), 16)
