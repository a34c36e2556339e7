"""The port's CUDA kernels against their plain versions on the card.

These tests need an NVIDIA card (a CUDA kernel has no CPU mode) and skip
without one. On the card:

    python -m pytest --noconftest tests/test_torch_port_kernels.py -m gpu

Every ``csrc/*.cu`` builds. row_shift and the patch gather are bit-equal to
their plain versions (both copy raw words or bytes), on every kernel path
their plans choose, the gather also on a 20,000 x 20,000 Visium slide.
Flash-attention tolerances: atol 2e-5 for the forward and both backward
kernels against their plain versions, the forward's l relative (fp32 on
both sides; sums in another order, the forward's online softmax rescaling,
and the kernels' 3xTF32 tensor-core products, which keep fp32 accuracy; the
plain versions are within ~2e-6 of float64 at these shapes). The flash
kernels are deterministic: the cluster ranks' partials are merged in a
fixed order.
"""

from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from mclstexp_tpu_torch.core.layers import MultiHeadSelfAttention
from mclstexp_tpu_torch.ops import augment, build
from mclstexp_tpu_torch.ops import flash_attention as fa
from mclstexp_tpu_torch.ops.flash_attention import attention_plain, flash_attention
from mclstexp_tpu_torch.ops.patches import extract_patches, extract_patches_plain, patch_plan
from mclstexp_tpu_torch.ops.row_shift import row_shift, row_shift_plain, shift_plan
from mclstexp_tpu_torch.profile_kernels import shift_inputs

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.gpu
def test_every_kernel_source_builds(cuda):
    """Each ``csrc/*.cu`` compiles for sm_90a (one nvcc process each, started
    together) into a library that loads."""
    sources = sorted(path.name for path in build.CSRC.glob("*.cu"))
    assert "linear_tf32.cu" in sources and len(sources) >= 9
    with ThreadPoolExecutor(len(sources)) as pool:
        built = dict(zip(sources, pool.map(build.build_library, sources)))
    for source, (path, _) in built.items():
        assert path.is_file(), source
        build.load_library(source)


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
@pytest.mark.parametrize("kind", ["random", "paeth"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_row_shift_kernel_at_the_flagship(cuda, dtype, kind):
    """(128, 224, 224, 3) at random shifts and at the Paeth shears of drawn
    angles, bit-equal in both layouts: the row shears launch shift_rows16,
    the column shear shift_cols_band."""
    cases = shift_inputs(cuda, dtype)
    for layout, kernel in (("rows", "shift_rows16"), ("cols", "shift_cols_band")):
        view, k = cases[(layout, kind)]
        before = dict(row_shift.kernel_launches)
        got = row_shift(view, k)
        assert row_shift.kernel_launches[kernel] == before[kernel] + 1
        torch.cuda.synchronize()
        assert got.stride() == view.stride()
        assert torch.equal(got, row_shift_plain(view, k))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout,t_shape,kernel", [
    ("cols", (3, 24, 40, 3), "shift_cols_band"),  # bands of 16 / 32 px, a narrower last
    ("cols", (2, 16, 38, 3), "shift_cols"),  # a memory row of 456 / 228 bytes
    ("cols", (1, 4096, 64, 3), "shift_cols"),  # the band's column exceeds 48 KB
    ("cols", "offset", "shift_cols"),  # the buffer one element off a 16-byte boundary
    ("rows", (3, 24, 40, 3), "shift_rows16"),  # source starts at every word residue
    ("rows", (2, 16, 1000, 4), "shift_rows16"),  # more chunks than threads
    ("rows", (2, 16, 38, 3), "shift_rows"),  # memory rows of no whole 16-byte chunks
    ("rows", "offset", "shift_rows"),
])
def test_row_shift_kernel_paths(cuda, dtype, layout, t_shape, kernel):
    """Each path the plan chooses, bit-equal to the plain version at
    clamp-edge shifts: the column layout on the (1, 2)-transpose of a
    contiguous T (B, rows, row_px, C), the row layout on T itself."""
    if t_shape == "offset":
        buf = torch.rand(3 * 24 * 40 * 3 + 1, generator=cuda, device="cuda").to(dtype)
        t = buf[1:].view(3, 24, 40, 3)
        assert t.data_ptr() % 16 != 0
    else:
        t = torch.rand(t_shape, generator=cuda, device="cuda").to(dtype)
    view = t.transpose(1, 2) if layout == "cols" else t
    b, rows, row_px, c = t.shape
    n, w = (row_px, rows) if layout == "cols" else (rows, row_px)  # shifts per image, clamp
    k = torch.randint(-w, w + 1, (b, n), generator=cuda, device="cuda", dtype=torch.int32)
    k[0, :6] = torch.tensor([0, w // 2, -(w // 2), w // 2 + 1, -w, 3 * w])
    assert shift_plan(b, rows, row_px, c, t.element_size(), layout == "cols",
                      aligned=t.data_ptr() % 16 == 0).kernel == kernel
    before = dict(row_shift.kernel_launches)
    got = row_shift(view, k)
    assert row_shift.kernel_launches[kernel] == before[kernel] + 1
    torch.cuda.synchronize()
    assert got.stride() == view.stride()
    assert torch.equal(got, row_shift_plain(view, k))


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
    shears are integers on both devices): two launches in the row layout
    (shift_rows16), one in the column layout (shift_cols_band)."""
    imgs = torch.rand((6, 16, 16, 3), generator=cuda, device="cuda")
    angles = torch.tensor([0.0, 90.0, 180.0, -90.0, 270.0, 0.0], device="cuda")
    hflip = torch.tensor([True, False, True, False, True, True], device="cuda")
    before, kernels = row_shift.launches, dict(row_shift.kernel_launches)
    got = augment.rotate_batch_paeth(imgs, angles, hflip)
    assert row_shift.launches == before + 3
    kernels["shift_rows16"] += 2
    kernels["shift_cols_band"] += 1
    assert row_shift.kernel_launches == kernels
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


FLAGSHIP_SHAPES = ((1, 8, 32, 64), (1, 8, 128, 64), (1, 8, 300, 64))  # eval sweep, train, ragged


@pytest.mark.gpu
def test_flash_forward_at_the_flagship_shapes(cuda):
    """The eval sweep's (1, 8, 32, 64), the training shape n = 128 (at least
    128 CTAs) and a ragged n = 300, read in place from a (b, n, 3, h, d) qkv
    buffer as the spot tower gives it, drawn in turn from seed 0: within
    2e-5 of the plain versions with and without residuals, and the same
    bits on a second run."""
    g = torch.Generator(device="cuda").manual_seed(0)
    for b, h, n, d in FLAGSHIP_SHAPES:
        if n == 128:
            assert fa.cluster_plan(b, h, n, d)[2] >= 128
        qkv = torch.randn((b, n, 3, h, d), generator=g, device="cuda")
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        got, *residuals = _check_forward(q, k, v, d**-0.5)
        assert torch.equal(flash_attention(q, k, v, d**-0.5), got)
        for x, y in zip(fa.flash_forward(q, k, v, d**-0.5, True),
                        fa.flash_forward(q, k, v, d**-0.5, True)):
            assert torch.equal(x, y)


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
    """A key mask launches the segment kernels (forward alone without a
    gradient; forward with residuals, dK/dV and dQ with one), counted in
    ``launches`` and ``segment_launches``; shapes outside the rule raise."""
    q = torch.randn((1, 2, 32, 16), generator=cuda, device="cuda")
    mask = torch.arange(32, device="cuda") < 20
    counts = lambda: tuple((w.launches, w.segment_launches) for w in (  # noqa: E731
        flash_attention, fa.flash_bwd_dkv, fa.flash_bwd_dq))
    before = counts()
    got = flash_attention(q, q, q, 0.25, mask)
    assert counts() == ((before[0][0] + 1, before[0][1] + 1), *before[1:])
    seg = mask.to(torch.int32)[None]
    torch.testing.assert_close(got, fa.flash_forward_plain(q, q, q, 0.25, seg)[0], rtol=0,
                               atol=2e-5)
    qg = q.clone().requires_grad_()
    before = counts()
    (g,) = torch.autograd.grad(flash_attention(qg, qg, qg, 0.25, mask).sum(), qg)
    assert torch.isfinite(g).all()
    assert counts() == tuple((c + 1, s + 1) for c, s in before)
    before = counts()
    (g,) = torch.autograd.grad(flash_attention(qg, qg, qg, 0.25).sum(), qg)
    assert counts() == tuple((c + 1, s) for c, s in before)
    with torch.no_grad():
        flash_attention(qg, qg, qg, 0.25)  # no gradient wanted: the forward alone runs
    with pytest.raises(ValueError, match="segment ids"):
        fa.flash_forward(q, q, q, 0.25, segment_ids=seg.long())
    with pytest.raises(ValueError, match="d <= 128"):
        x = torch.zeros((1, 1, 4, 160), device="cuda")
        flash_attention(x, x, x, 1.0)
    with pytest.raises(TypeError, match="float32"):
        flash_attention(q.half(), q.half(), q.half(), 0.25)


@pytest.mark.gpu
def test_bf16_kernels_raise_rather_than_cast(cuda):
    """A bf16 CUDA tensor reaches the bf16 kernel (through the Function,
    forward and backward) and nothing else; half precision raises."""
    q = torch.randn((1, 2, 40, 64), generator=cuda, device="cuda").bfloat16()
    qg = q.clone().requires_grad_()
    counts = lambda: [(w.launches, w.bf16_launches)  # noqa: E731
                      for w in (fa.flash_attention, fa.flash_bwd_dkv, fa.flash_bwd_dq)]
    before = counts()
    (g,) = torch.autograd.grad(flash_attention(qg, qg, qg, 0.125).float().sum(), qg)
    assert g.dtype == torch.bfloat16 and torch.isfinite(g.float()).all()
    assert counts() == [(c, b + 1) for c, b in before]
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention(q.half(), q.half(), q.half(), 0.125)


def _segment_ids(cuda, b, n, kind):
    """(b, n) int32 ids: "tail", a padded tail of min(127, n - 1) rows in
    row 0 and of 1 row in the others (the baselines' mask as int32: real
    rows 1, padded 0); "interleaved", ids drawn from {0, 1, 2}."""
    if kind == "interleaved":
        return torch.randint(0, 3, (b, n), generator=cuda, device="cuda", dtype=torch.int32)
    seg = torch.ones((b, n), dtype=torch.int32, device="cuda")
    seg[0, n - min(127, n - 1):] = 0
    seg[1:, n - min(1, n - 1):] = 0
    return seg


def _check_segment_kernels(q, k, v, seg, scale):
    """The three kernels with segment ids against their plain versions (atol
    2e-5, l relative), deterministic, one (segment) launch each; and the
    padded rows' output is the segment softmax's, not the key mask's."""
    counts = lambda: tuple((w.launches, w.segment_launches) for w in (  # noqa: E731
        flash_attention, fa.flash_bwd_dkv, fa.flash_bwd_dq))
    before = counts()
    out, l, m = fa.flash_forward(q, k, v, scale, residuals=True, segment_ids=seg)
    alone = fa.flash_forward(q, k, v, scale, segment_ids=seg)
    do = torch.randn(q.shape, device="cuda")
    want_out, want_l, want_m = fa.flash_forward_plain(q, k, v, scale, seg)
    di = (want_out * do).sum(-1).contiguous()
    args = (q, k, v, do, want_l, want_m, di, scale, seg)
    dk, dv = fa.flash_bwd_dkv(*args)
    dq = fa.flash_bwd_dq(*args)
    assert counts() == ((before[0][0] + 2, before[0][1] + 2), (before[1][0] + 1, before[1][1] + 1),
                        (before[2][0] + 1, before[2][1] + 1))
    torch.cuda.synchronize()
    assert all(torch.isfinite(t).all() for t in (out, l, m, alone, dk, dv, dq))
    for got, want in ((out, want_out), (alone, want_out), (m, want_m),
                      *zip((dk, dv), fa.flash_bwd_dkv_plain(*args)),
                      (dq, fa.flash_bwd_dq_plain(*args))):
        torch.testing.assert_close(got, want, rtol=0, atol=FLASH_ATOL)
    torch.testing.assert_close(l, want_l, rtol=FLASH_ATOL, atol=0)
    again = (*fa.flash_forward(q, k, v, scale, residuals=True, segment_ids=seg),
             *fa.flash_bwd_dkv(*args), fa.flash_bwd_dq(*args))
    for a, b in zip((out, l, m, dk, dv, dq), again):
        assert torch.equal(a, b)
    padded = seg == 0
    if padded.any() and (~padded).any():
        key_mask = fa.attention_plain(q, k, v, scale, seg != 0)
        rows = padded[:, None, :, None].expand_as(out)
        assert (out - key_mask)[rows].abs().max() > 1e-3  # the key mask differs there


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["tail", "interleaved"])
@pytest.mark.parametrize("strided", [False, True], ids=["contiguous", "qkv_views"])
@pytest.mark.parametrize("n", [1, 66, 128, 300, 384, 1000, 4096])
@pytest.mark.parametrize("d", [16, 64, 128])
def test_flash_segment_kernels_match_plain(cuda, n, d, strided, kind):
    """Forward (with and without residuals), dK/dV and dQ with segment ids at
    (2, 4, n, d): padded tails of 127 and 1 rows and interleaved ids, on the
    design ``fp32_plan`` picks: the cluster kernels at n <= 384 or d = 128,
    every split of their plan (128: 4, where a padded row's first ranks see
    no key of its segment; 4,096 at d = 128: 1), and the warpgroup kernels
    at n = 1,000 and 4,096 with d <= 64 (the cluster kernels there:
    ``test_flash_segment_cluster_kernels_at_long_n``)."""
    q, k, v = _qkv(cuda, 2, 4, n, d, strided)
    _check_segment_kernels(q, k, v, _segment_ids(cuda, 2, n, kind), d**-0.5)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 8, 128, 64), (1, 16, 384, 64), (1, 16, 768, 64),
                                   (1, 1, 32, 32), (1, 1, 32, 62), (1, 1, 32, 64),
                                   (1, 1, 32, 128)])
def test_flash_segment_kernels_at_the_baselines_shapes(cuda, shape):
    """The slide baselines' heads at her2st-like lengths, padded to a
    128-multiple ((1, 8, 128, 64) splits each walk 4 ways: a padded row's
    last rank sees only real keys; (1, 16, 384 / 768, 64) run the warpgroup
    kernels under ``fp32_plan``), and on unaligned inputs (4-byte staging on
    the cluster kernels); one 32-row tile at each D (1, 1, 32, 64) is the smallest case
    at which a form of the dQ kernel that staged its owned rows' ids in
    shared memory raised an illegal address (ptxas -O1 and above)."""
    b, h, n, d = shape
    seg = (torch.arange(n, device="cuda") < n - 50).to(torch.int32)[None]
    _check_segment_kernels(*_qkv(cuda, b, h, n, d, True), seg, 0.125)
    _check_segment_kernels(*_offset_views(cuda, b, h, n, d), seg, 0.125)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,kind", [((2, 4, 4096, 64), "tail"),
                                        ((2, 4, 1000, 64), "interleaved"),
                                        ((1, 16, 768, 64), "tail")])
def test_flash_segment_cluster_kernels_at_long_n(cuda, monkeypatch, shape, kind):
    """The cluster kernels with segment ids at lengths where ``fp32_plan``
    picks the warpgroup kernels (its crossover moved past them), against
    their plain versions, on the views of a qkv buffer and on unaligned
    inputs: the design any shape below the crossover runs, held at long n."""
    monkeypatch.setattr(fa, "WG_MIN_N", 2**31)
    b, h, n, d = shape
    assert fa.fp32_plan(*shape)[0] == "cluster"
    seg = _segment_ids(cuda, b, n, kind)
    wg = [w.wg_launches for w in (flash_attention, fa.flash_bwd_dkv, fa.flash_bwd_dq)]
    _check_segment_kernels(*_qkv(cuda, b, h, n, d, True), seg, d**-0.5)
    _check_segment_kernels(*_offset_views(cuda, b, h, n, d), seg, d**-0.5)
    assert [w.wg_launches for w in (flash_attention, fa.flash_bwd_dkv, fa.flash_bwd_dq)] == wg


@pytest.mark.gpu
def test_flash_segment_kernels_at_the_slides(cuda):
    """The three kernels with segment ids at (1, 16, n, 64), the slide
    baselines' heads, drawn in turn from seed 8: padded tails of 384 rows (346
    real), 768 (705), 4,096 (3,969: the whole slide) and interleaved ids at
    768, on the design ``fp32_plan`` picks. Each within 2e-5 of its plain
    version (the forward with and without residuals; l relative), the same
    bits on a second run, and the padded rows' output the segment softmax's,
    not the key mask's."""
    g = torch.Generator(device="cuda").manual_seed(8)
    for n, real, kind in ((384, 346, "tail"), (768, 705, "tail"), (4096, 3969, "tail"),
                          (768, None, "interleaved")):
        q, k, v, do, _, _, _, scale = _kernel_residuals_case(g, (1, 16, n, 64))
        if kind == "interleaved":
            seg = torch.randint(0, 3, (1, n), generator=g, device="cuda", dtype=torch.int32)
        else:
            seg = (torch.arange(n, device="cuda") < real).to(torch.int32)[None]
        out, l, m = fa.flash_forward(q, k, v, scale, residuals=True, segment_ids=seg)
        alone = fa.flash_forward(q, k, v, scale, segment_ids=seg)
        want, want_l, want_m = fa.flash_forward_plain(q, k, v, scale, seg)
        args = (q, k, v, do, want_l, want_m, (want * do).sum(-1).contiguous(), scale, seg)
        dk, dv = fa.flash_bwd_dkv(*args)
        dq = fa.flash_bwd_dq(*args)
        for got, ref in ((out, want), (alone, want), (m, want_m),
                         *zip((dk, dv), fa.flash_bwd_dkv_plain(*args)),
                         (dq, fa.flash_bwd_dq_plain(*args))):
            torch.testing.assert_close(got, ref, rtol=0, atol=FLASH_ATOL, msg=f"{n} {kind}")
        torch.testing.assert_close(l, want_l, rtol=FLASH_ATOL, atol=0)
        again = (*fa.flash_forward(q, k, v, scale, residuals=True, segment_ids=seg),
                 *fa.flash_bwd_dkv(*args), fa.flash_bwd_dq(*args))
        assert all(torch.equal(a, b) for a, b in zip((out, l, m, dk, dv, dq), again))
        padded = seg[0] == 0
        if padded.any():
            key_mask = fa.attention_plain(q, k, v, scale, seg != 0)
            assert float((out - key_mask)[:, :, padded].abs().max()) > 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("n", [100, 384])
def test_flash_segment_autograd_matches_plain_autograd(cuda, n):
    """torch.autograd.grad through flash_attention with a mask (the segment
    kernels) against autograd of the plain segment forward, on the views of
    one qkv buffer."""
    qkv = torch.randn((1, n, 3, 8, 64), generator=cuda, device="cuda", requires_grad=True)
    cot = torch.randn((1, 8, n, 64), generator=cuda, device="cuda")
    mask = torch.arange(n, device="cuda") < n - 37
    seg = mask.to(torch.int32)[None]

    def grad(attend):
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        return torch.autograd.grad((attend(q, k, v) * cot).sum(), qkv)[0]

    got = grad(lambda q, k, v: flash_attention(q, k, v, 0.125, mask))
    want = grad(lambda q, k, v: fa.flash_forward_plain(q, k, v, 0.125, seg)[0])
    torch.testing.assert_close(got, want, rtol=0, atol=FLASH_ATOL)


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


def _kernel_residuals_case(g, shape):
    """The backward kernels' arguments at ``shape``: q, k, v as the views of a
    (b, n, 3, h, d) qkv buffer and dout, drawn from ``g``; the kernel
    forward's l and m, and di = rowsum(out * dout)."""
    b, h, n, d = shape
    qkv = torch.randn((b, n, 3, h, d), generator=g, device="cuda")
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    do = torch.randn((b, h, n, d), generator=g, device="cuda")
    out, l, m = fa.flash_forward(q, k, v, d**-0.5, residuals=True)
    return q, k, v, do, l, m, (out * do).sum(-1).contiguous(), d**-0.5


@pytest.mark.gpu
def test_flash_backward_at_the_flagship_shapes(cuda):
    """dK/dV and dQ fed the kernel forward's l and m at the training shape
    (1, 8, 128, 64) (at least 128 CTAs), the remainder batch's n = 66 and a
    ragged n = 300, drawn in turn from seed 1: within 2e-5 of their plain
    versions."""
    g = torch.Generator(device="cuda").manual_seed(1)
    for shape in ((1, 8, 128, 64), (1, 8, 66, 64), (1, 8, 300, 64)):
        if shape[2] == 128:
            assert fa.cluster_plan(*shape)[2] >= 128
        args = _kernel_residuals_case(g, shape)
        for got, want in ((fa.flash_bwd_dkv(*args), fa.flash_bwd_dkv_plain(*args)),
                          ((fa.flash_bwd_dq(*args),), (fa.flash_bwd_dq_plain(*args),))):
            for x, y in zip(got, want):
                torch.testing.assert_close(x, y, rtol=0, atol=FLASH_ATOL, msg=str(shape))


@pytest.mark.gpu
def test_flash_kernels_at_the_whole_slide_attention(cuda):
    """(1, 16, 4,096, 64) from seed 2, on the design ``fp32_plan`` picks: the
    forward with residuals within 2e-5 of ``flash_forward_plain`` (l
    relative), dK/dV and dQ fed its l and m within 2e-5 of their plain
    versions."""
    q, k, v, do, l, m, di, scale = args = _kernel_residuals_case(
        torch.Generator(device="cuda").manual_seed(2), (1, 16, 4096, 64))
    got, want = fa.flash_forward(q, k, v, scale, residuals=True), fa.flash_forward_plain(
        q, k, v, scale)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=FLASH_ATOL)
    torch.testing.assert_close(got[1], want[1], rtol=FLASH_ATOL, atol=0)
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=FLASH_ATOL)
    for x, y in zip((*fa.flash_bwd_dkv(*args), fa.flash_bwd_dq(*args)),
                    (*fa.flash_bwd_dkv_plain(*args), fa.flash_bwd_dq_plain(*args))):
        torch.testing.assert_close(x, y, rtol=0, atol=FLASH_ATOL)


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
@pytest.mark.parametrize("p", [15, 16, 32, 224])
@pytest.mark.parametrize("c", [1, 3, 4])
def test_extract_patches_kernel_at_every_start_residue(cuda, c, p):
    """A 50 x 83 slide (W * C = 83, 249, 332 bytes: no multiple of 16), once
    16-byte aligned and once one byte off; crop starts x0 from -20 to W + 3
    (every residue mod 16) on rows inside, across the edges and outside:
    bit-equal on the 16-byte path (P * C a multiple of 16) and the byte
    path (P = 15)."""
    buf = torch.randint(0, 256, (50 * 83 * c + 1,), generator=cuda, device="cuda",
                        dtype=torch.int32).to(torch.uint8)
    r = p // 2
    xs = torch.arange(r - 20, r + 87)
    ys = torch.tensor([r, 25, 49, -r + 3, 50 + r - 3, -250])
    centers = torch.stack([xs, ys[xs % len(ys)]], 1).cuda()
    for slide in (buf[:-1].view(50, 83, c), buf[1:].view(50, 83, c)):
        before = extract_patches.launches
        got = extract_patches(slide, centers, p)
        assert extract_patches.launches == before + 1
        assert torch.equal(got, extract_patches_plain(slide, centers, p))
    assert patch_plan(len(xs), p, c).kernel == ("gather_bytes" if p == 15 else "gather_rows16")


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


@pytest.mark.gpu
def test_extract_patches_kernel_small_cases_then_visium_slide(cuda):
    """From seed 4, bit-equal to the plain version: 60 x 80 and 50 x 83
    slides at C 1, 3, 4 and P 15, 16, 32, 224 (the centers of
    ``test_extract_patches_kernel_matches_plain`` and crop starts at every
    residue mod 16), both of ``patch_plan``'s kernels, N = 0; then a 20,000 x
    20,000 x 3 slide (a Visium full-resolution image, 1.2 GB) with 4,992 grid
    centers and 64 at and past its border, P = 224."""
    from mclstexp_tpu_torch.profile_kernels import PATCH, patch_input

    g = torch.Generator(device="cuda").manual_seed(4)
    small = torch.tensor(PATCH_CENTERS, device="cuda")
    kernels = set()
    for c in (1, 3, 4):
        slide = torch.randint(0, 256, (60, 80, c), generator=g, device="cuda",
                              dtype=torch.uint8)
        odd = torch.randint(0, 256, (50, 83, c), generator=g, device="cuda", dtype=torch.uint8)
        for p in (15, 16, 32, 224):
            r = p // 2
            xs = torch.arange(r - 20, r + 83 + 4)
            ys = torch.tensor([r, 25, 49, -r + 3, 50 + r - 3, -250])
            residues = torch.stack([xs, ys[xs % len(ys)]], 1).cuda()
            for s, centers in ((slide, small), (odd, residues)):
                assert torch.equal(extract_patches(s, centers, p),
                                   extract_patches_plain(s, centers, p)), (tuple(s.shape), p)
            kernels.add(patch_plan(len(small), p, c).kernel)
        assert extract_patches(slide, small[:0], 16).shape == (0, 16, 16, c)
    assert kernels == {"gather_rows16", "gather_bytes"}

    slide, _, centers = patch_input(g)
    got = extract_patches(slide, centers, PATCH)
    assert torch.equal(got, extract_patches_plain(slide, centers, PATCH))
    del slide, got
    torch.cuda.empty_cache()
