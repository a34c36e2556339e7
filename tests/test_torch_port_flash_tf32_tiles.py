"""The fp32 flash kernels' warpgroup design and the plan that picks it.

For long sequences the three fp32 kernels run as Hopper warpgroup kernels
(``csrc/flash_attention_tf32.cu``, ``csrc/flash_attention_bwd_tf32.cu``,
``csrc/flash_tf32.cuh``): 64-row ``wgmma`` tiles in tf32, every product
3xTF32, on split copies of the inputs that one plain-load pass writes
before each pass (the big and small tf32 parts, in rows and transposed,
since a tf32 ``wgmma`` reads its shared-memory operands K-major only).
``fp32_plan`` picks that design or the cluster kernels from (b, h, n, d),
and on the warpgroup design dK/dV's CTAs of 64 keys (one warpgroup) or of
128 (two warpgroups on one ring of query tiles). On the CPU:

  (a) ``fp32_plan`` at every shape the benchmark's cells and the card tests
      launch, its crossovers and its limits;
  (b) that ``flash_forward`` and the backward route an fp32 tensor by the
      plan, with and without segment ids (stand-in entry points record the
      launches), and count the warpgroup launches in ``wg_launches`` and the
      128-key dK/dV's in ``flash_bwd_dkv.wg128_launches``;
  (c) the split copies' layouts: the column form's row order and the
      register A operand it lets the accumulator be, and the 3xTF32 split
      (tf32 rounding, big + small, the three products' error);
  (d) a numpy model of the forward's walk (32-key tiles, an online softmax
      in fp32, 3xTF32 products summed per tile, tiles added in fp32) held to
      ``flash_forward_plain``, with and without segment ids.

On the card (``gpu`` marker), with dK/dV on each of its two designs: the
three kernels against their plain versions at the slide baselines' (1, 16,
384 / 768 / 4,096, 64) with segment ids, at ragged n (a last 128-key CTA with
one warpgroup's keys or a few of the second's), at d = 32 (and d = 128,
which the plan keeps on the cluster kernels), on inputs TMA could not copy
as they are (the split pass reads them), the same bits on two runs, and
autograd through ``flash_attention``:

    python -m pytest --noconftest tests/test_torch_port_flash_tf32_tiles.py -m gpu
"""

import contextlib
import types

import numpy as np
import pytest
import torch

from mclstexp_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)

LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453


# --- (a) the plan -----------------------------------------------------------------------------

@pytest.mark.parametrize("shape,want", [
    ((1, 8, 32, 64), ("cluster", 32, 1, 8, 32)),         # eval sweep, key database
    ((1, 8, 128, 64), ("cluster", 32, 4, 128, 32)),      # spot tower training (her2st-train)
    ((1, 8, 66, 64), ("cluster", 32, 3, 72, 32)),        # the fold's remainder batch
    ((1, 8, 300, 64), ("cluster", 32, 2, 160, 32)),      # ragged
    ((1, 16, 384, 64), ("warpgroup", 64, 1, 96, 64)),    # HisToGene her2st slides: buckets of 128
    ((1, 16, 512, 64), ("warpgroup", 64, 1, 128, 64)),
    ((1, 16, 576, 64), ("warpgroup", 64, 1, 144, 128)),  # 80 CTAs of 128 keys: the 128-key dK/dV
    ((1, 16, 640, 64), ("warpgroup", 64, 1, 160, 128)),
    ((1, 16, 768, 64), ("warpgroup", 64, 1, 192, 128)),
    ((1, 16, 1024, 64), ("warpgroup", 64, 1, 256, 128)),
    ((1, 8, 1024, 64), ("warpgroup", 64, 1, 128, 64)),    # 64 CTAs of 128 keys: 64-key ones
    ((1, 8, 1088, 64), ("warpgroup", 64, 1, 136, 128)),   # 72
    ((1, 16, 4096, 64), ("warpgroup", 64, 1, 1024, 128)),  # the whole slide (histogene-visium-slide)
    ((1, 16, 4096, 32), ("warpgroup", 64, 1, 1024, 128)),
    ((1, 16, 4096, 128), ("cluster", 32, 1, 2048, 32)),  # d > 64: the cluster kernels
    ((1, 16, 256, 64), ("cluster", 32, 2, 256, 32)),     # below the crossover: n < 320
    ((1, 16, 320, 64), ("warpgroup", 64, 1, 80, 64)),    # at it
    ((1, 8, 512, 64), ("cluster", 32, 2, 256, 32)),      # 64 blocks of 64 rows: too few
    ((1, 8, 640, 64), ("warpgroup", 64, 1, 80, 64)),
    ((1, 1, 4096, 64), ("cluster", 32, 2, 256, 32)),
    ((2, 8, 4000, 64), ("warpgroup", 64, 1, 1008, 128)),
])
def test_fp32_plan_at_the_launched_shapes(shape, want):
    """The warpgroup design where d <= 64, n >= 320 and its b * h * ceil(n
    / 64) CTAs are at least 80, its dK/dV on 128-key CTAs where b * h *
    ceil(n / 128) of them reach ``WG128_MIN_CTAS`` and on 64-key CTAs
    below; the cluster kernels (``cluster_plan``) elsewhere."""
    assert fa.fp32_plan(*shape) == want
    if want[0] == "cluster":
        assert want[1:4] == fa.cluster_plan(*shape) and want[4] == want[1]


@pytest.mark.parametrize("shape", [(1, 1, 1, 0), (1, 1, 1, 129), (1, 1, 0, 64), (0, 1, 8, 64),
                                   (1, 1, 65535 * 32 + 1, 64), (1, 0, 4096, 64)])
def test_fp32_plan_limits_raise(shape):
    with pytest.raises(ValueError):
        fa.fp32_plan(*shape)


def test_fp32_plan_keeps_the_split_pass_grid():
    """b * h above 65535 (the split pass's grid) stays on the cluster kernels."""
    assert fa.fp32_plan(1, 65535, 384, 64)[0] == "warpgroup"
    assert fa.fp32_plan(1, 65536, 384, 64)[0] == "cluster"


# --- (b) routing ------------------------------------------------------------------------------

ROUTED = [(1, 8, 128, 64), (1, 8, 32, 64), (1, 16, 384, 64), (1, 16, 768, 64),
          (1, 16, 4096, 64), (1, 16, 4096, 128), (1, 16, 256, 64), (2, 3, 700, 20),
          (1, 16, 4096, 32)]
DKV_DESIGNS = ("keys64", "keys128")


def _dkv_design(monkeypatch, design):
    """dK/dV on 64-key CTAs (``design`` "keys64") or on 128-key CTAs
    ("keys128") at every shape the warpgroup design takes."""
    monkeypatch.setattr(fa, "WG128_MIN_CTAS", 1 if design == "keys128" else 2**31)


@contextlib.contextmanager
def _stand_ins(monkeypatch):
    """Entry points that record (design, b, h, n, d, rows, split) instead of
    launching; CPU tensors taken for CUDA ones, the CUDA device and stream
    calls made harmless."""
    seen = []

    def cluster(*args):  # pointers, ids, strides, b, h, n, d, rows, split, scale, stream
        seen.append(("cluster", *args[-8:-2]))
        return 0

    def warpgroup(*args):  # pointers, scratch, ids, strides, b, h, n, d, scale, stream
        seen.append(("warpgroup", *args[-6:-2]))
        return 0

    def warpgroup128(*args):  # the backward whose dK/dV owns 128 keys a CTA
        seen.append(("warpgroup128", *args[-6:-2]))
        return 0

    monkeypatch.setattr(fa, "_on_cuda", lambda q, what: True)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(fa, "_fwd_entry", lambda dtype: cluster)
    monkeypatch.setattr(fa, "_bwd_entries", lambda dtype: (cluster, cluster))
    monkeypatch.setattr(fa, "_tf32_entries", lambda: (warpgroup, warpgroup, warpgroup128))
    yield seen


def _tensors(shape, ids):
    b, h, n, d = shape
    q = torch.empty((b, n, 3, h, d))[:, :, 0].transpose(1, 2)  # a view of a qkv buffer
    stats = torch.empty((b, h, n))
    seg = torch.ones((b, n), dtype=torch.int32) if ids else None
    return q, stats, seg


@pytest.mark.parametrize("ids", [False, True], ids=["no_ids", "ids"])
@pytest.mark.parametrize("shape", ROUTED, ids=str)
def test_fp32_launches_follow_the_plan(monkeypatch, shape, ids):
    """An fp32 forward and backward launch the design ``fp32_plan`` picks
    (the cluster entries with ``cluster_plan``'s rows and split, or one
    warpgroup entry a pass for forward and for both backward kernels, the
    backward's with the 128-key dK/dV where the plan gives it 128 keys), with
    or without segment ids, and count it."""
    design, rows, split, _, dkv_rows = fa.fp32_plan(*shape)
    q, stats, seg = _tensors(shape, ids)
    counters = (fa.flash_attention, fa.flash_bwd_dkv, fa.flash_bwd_dq)
    before = [(w.launches, w.segment_launches, w.wg_launches) for w in counters]
    wide = fa.flash_bwd_dkv.wg128_launches
    with _stand_ins(monkeypatch) as seen:
        fa.flash_forward(q, q, q, 0.125, residuals=True, segment_ids=seg)
        fa.flash_backward(q, q, q, q, stats, stats, stats, 0.125, seg)
    keys128 = dkv_rows == 128
    if design == "warpgroup":
        assert seen == [("warpgroup", *shape), ("warpgroup128" if keys128 else "warpgroup", *shape)]
    else:
        assert seen == [("cluster", *shape, rows, split)] * 3
    wg = design == "warpgroup"
    assert [(w.launches, w.segment_launches, w.wg_launches) for w in counters] == [
        (a + 1, s + ids, g + wg) for a, s, g in before]
    assert fa.flash_bwd_dkv.wg128_launches == wide + keys128


def test_bf16_keeps_its_own_plan(monkeypatch):
    """A bf16 tensor at a warpgroup-plan shape still takes the bf16 kernels
    (``bf16_plan``), never the fp32 warpgroup entries."""
    shape = (1, 16, 4096, 64)
    q = torch.empty(shape, dtype=torch.bfloat16)
    stats = torch.empty(shape[:3])
    with _stand_ins(monkeypatch) as seen:
        fa.flash_forward(q, q, q, 0.125, residuals=True)
        fa.flash_backward(q, q, q, q, stats, stats, stats, 0.125)
    assert seen == [("cluster", *shape, 64, 1)] * 3


@pytest.mark.parametrize("design", DKV_DESIGNS)
@pytest.mark.parametrize("dkv", [True, False], ids=["dkv", "dq"])
def test_one_backward_kernel_alone(monkeypatch, dkv, design):
    """``flash_bwd_dkv`` or ``flash_bwd_dq`` alone (``flash_backward`` with
    one of them) launches a warpgroup entry once and counts only that
    kernel: dK/dV alone on the entry of its design (``wg128_launches`` for
    the 128-key one), dQ alone on the plain backward entry."""
    _dkv_design(monkeypatch, design)
    shape = (1, 16, 768, 64)
    q, stats, _ = _tensors(shape, False)
    before = (fa.flash_bwd_dkv.wg_launches, fa.flash_bwd_dq.wg_launches,
              fa.flash_bwd_dkv.wg128_launches)
    with _stand_ins(monkeypatch) as seen:
        if dkv:
            got = fa.flash_bwd_dkv(q, q, q, q, stats, stats, stats, 0.125)
        else:
            got = (fa.flash_bwd_dq(q, q, q, q, stats, stats, stats, 0.125),)
    keys128 = dkv and design == "keys128"
    assert seen == [("warpgroup128" if keys128 else "warpgroup", *shape)]
    assert len(got) == (2 if dkv else 1) and all(t.shape == shape for t in got)
    assert (fa.flash_bwd_dkv.wg_launches, fa.flash_bwd_dq.wg_launches,
            fa.flash_bwd_dkv.wg128_launches) == (before[0] + dkv, before[1] + (not dkv),
                                                 before[2] + keys128)


@pytest.mark.parametrize("dkv,dq", [(True, True), (True, False), (False, True)])
def test_flash_backward_on_the_cpu_is_the_plain_versions(dkv, dq):
    """On CPU tensors ``flash_backward`` returns the plain versions' dk, dv
    and dq, None for a part not asked, and counts no launch."""
    g = torch.Generator().manual_seed(3)
    q, k, v, do = (torch.randn((1, 2, 40, 16), generator=g) for _ in range(4))
    seg = (torch.arange(40) >= 30).to(torch.int32)[None].contiguous()
    out, l, m = fa.flash_forward_plain(q, k, v, 0.25, seg)
    di = (out * do).sum(-1)
    counters = (fa.flash_bwd_dkv.launches, fa.flash_bwd_dq.launches)
    dk, dv, dq_out = fa.flash_backward(q, k, v, do, l, m, di, 0.25, seg, dkv=dkv, dq=dq)
    want_dk, want_dv = fa.flash_bwd_dkv_plain(q, k, v, do, l, m, di, 0.25, seg)
    want_dq = fa.flash_bwd_dq_plain(q, k, v, do, l, m, di, 0.25, seg)
    assert (dk is None, dv is None, dq_out is None) == (not dkv, not dkv, not dq)
    for got, want in ((dk, want_dk), (dv, want_dv), (dq_out, want_dq)):
        assert got is None or torch.equal(got, want)
    assert (fa.flash_bwd_dkv.launches, fa.flash_bwd_dq.launches) == counters


# --- (c) the split copies ---------------------------------------------------------------------

def col_pos(r):
    """csrc/flash_tf32.cuh ``col_pos``: the position of row r in the column form."""
    return (r & ~7) | ((r & 1) << 2) | ((r & 7) >> 1)


def col_row(p):
    return (p & ~7) | ((p & 3) << 1) | ((p >> 2) & 1)


def test_column_order_is_a_bijection_within_each_group_of_8():
    assert [col_row(p) for p in range(8)] == [0, 2, 4, 6, 1, 3, 5, 7]
    assert all(col_row(col_pos(r)) == r and col_pos(r) // 8 == r // 8 for r in range(256))


def accumulator(w, g, t, i):
    """(row, column) of register i of thread (warp w, lane 4g + t) in a
    wgmma m64nN accumulator."""
    return 16 * w + g + 8 * ((i >> 1) & 1), 8 * (i >> 2) + 2 * t + (i & 1)


def a_operand(w, g, t, x):
    """(row, logical column) of register x of the tf32 m64k8 register A
    operand: rows 16w + g (+8), columns t (+4) (PTX ISA, wgmma register A)."""
    return 16 * w + g + 8 * (x & 1), t + 4 * (x >> 1)


@pytest.mark.parametrize("ks", [4, 8])
def test_accumulator_is_the_a_operand_under_the_column_order(ks):
    """``split_a`` hands A register x of slice j the accumulator register
    (0, 2, 1, 3)[x] of that slice; against B in the column form (position p
    of a slice holding row col_row(p)) the product is the accumulator's own
    product: sum_k A[r, k] B[c, k] == (x @ v)[r, c]."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 8 * ks))
    v = rng.standard_normal((8 * ks, 16))
    a = np.zeros_like(x)  # the A operand in logical column order
    for w in range(4):
        for g in range(8):
            for t in range(4):
                for j in range(ks):
                    for reg, src in enumerate((0, 2, 1, 3)):
                        r, c = accumulator(w, g, t, 4 * j + src)
                        ar, ac = a_operand(w, g, t, reg)
                        assert ar == r
                        a[ar, 8 * j + ac] = x[r, c]
    b = np.stack([v[(p & ~7) | col_row(p & 7)] for p in range(8 * ks)])  # column form of v
    np.testing.assert_allclose(a @ b, x @ v, rtol=1e-12, atol=1e-12)


def tf32(x):
    """cvt.rna.tf32.f32: fp32 x rounded to 10 mantissa bits, ties away from
    zero, the low 13 bits 0 (finite inputs)."""
    bits = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return ((bits + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)


def split(x):
    x = np.asarray(x, np.float32)
    big = tf32(x)
    return big, tf32(x - big)


def test_tf32_split_keeps_fp32():
    """big has 11 significant bits, small the next 11: big + small is x to
    ~2^-22, and the 3xTF32 product (small terms first, then big * big) is
    within ~2^-21 of the exact one; one TF32 product is not."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal(4096).astype(np.float32) * np.float32(3.0) ** rng.integers(
        -8, 8, 4096)
    y = rng.standard_normal(4096).astype(np.float32)
    (xb, xs), (yb, ys) = split(x), split(y)
    assert np.all(tf32(xb) == xb) and np.all(tf32(xs) == xs)
    assert np.all(np.abs(xs) <= np.abs(x) * 2.0**-11)
    np.testing.assert_array_less(np.abs(xb.astype(np.float64) + xs - x), np.abs(x) * 2.0**-21)
    exact = x.astype(np.float64) * y
    three = (xs.astype(np.float64) * yb + xb.astype(np.float64) * ys) + xb.astype(
        np.float64) * yb
    one = tf32(x).astype(np.float64) * tf32(y)
    assert np.all(np.abs(three - exact) <= np.abs(exact) * 2.0**-20)
    assert np.max(np.abs(one - exact) / np.abs(exact)) > 2.0**-12


# --- (d) the forward's walk -------------------------------------------------------------------

def product3(a, b):
    """a @ b^T in 3xTF32 with fp32 results: each product of tf32 parts exact
    (float64), the small terms summed first, then big * big; rounded to fp32
    once (the tensor cores' rounding inside a tile is not modelled)."""
    (ab, as_), (bb, bs) = split(a), split(b)
    t = lambda u, w: np.matmul(u.astype(np.float64), np.swapaxes(w, -1, -2))  # noqa: E731
    return ((t(as_, bb) + t(ab, bs)) + t(ab, bb)).astype(np.float32)


def forward_model(q, k, v, scale, seg, w=32):
    """The warpgroup forward on (b, h, n, d) fp32 arrays: per tile of w keys
    in order, S = Q K^T in 3xTF32, the online softmax in fp32 (scores in
    log2 units, the running max m, l summing p), the tile's P V in 3xTF32
    added to out * alpha in fp32; out = out / l, m back in natural units."""
    n = q.shape[2]
    m = np.full(q.shape[:3], -np.inf, np.float32)
    l = np.zeros(q.shape[:3], np.float32)
    o = np.zeros(q.shape, np.float32)
    same = None if seg is None else seg[:, None, :, None] == seg[:, None, None, :]
    with np.errstate(invalid="ignore"):
        for k0 in range(0, n, w):
            s = product3(q, k[..., k0:k0 + w, :]) * np.float32(scale * LOG2E)
            if same is not None:
                s = np.where(same[..., k0:k0 + w], s, -np.inf).astype(np.float32)
            m_new = np.maximum(m, s.max(-1))
            alpha = np.where(m == -np.inf, 0, np.exp2(m - m_new)).astype(np.float32)
            p = np.where(s == -np.inf, 0, np.exp2(s - m_new[..., None])).astype(np.float32)
            l = l * alpha + p.sum(-1, dtype=np.float32)
            o = o * alpha[..., None] + product3(p, np.swapaxes(v[..., k0:k0 + w, :], -1, -2))
            m = m_new
    return o / l[..., None], l, m * np.float32(LN2)


@pytest.mark.parametrize("n", [1, 31, 33, 100, 320])
@pytest.mark.parametrize("kind", ["none", "tail", "interleaved"])
def test_forward_model_is_the_plain_version(n, kind):
    """The walk's tiles, rescales and masks give the plain forward's out, l
    and m to fp32 accuracy (2e-6, l relative)."""
    rng = np.random.default_rng(n)
    q, k, v = (rng.standard_normal((1, 2, n, 16)).astype(np.float32) for _ in range(3))
    seg = None
    if kind == "tail":
        seg = (np.arange(n) < max(1, n - 7)).astype(np.int32)[None]
    elif kind == "interleaved":
        seg = rng.integers(0, 3, (1, n)).astype(np.int32)
    got = forward_model(q, k, v, 0.25, seg)
    want = fa.flash_forward_plain(*(torch.from_numpy(x) for x in (q, k, v)), 0.25,
                                  None if seg is None else torch.from_numpy(seg))
    np.testing.assert_allclose(got[0], want[0].numpy(), rtol=0, atol=2e-6)
    np.testing.assert_allclose(got[1], want[1].numpy(), rtol=2e-6, atol=0)
    np.testing.assert_allclose(got[2], want[2].numpy(), rtol=0, atol=2e-6)


# --- on the card ------------------------------------------------------------------------------

ATOL = 2e-5  # as the cluster kernels' card tests: fp32, sums in another order


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.Generator(device="cuda").manual_seed(21)


def _inputs(g, b, h, n, d, layout="qkv"):
    """fp32 q, k, v as views of one (b, n, 3, h, d) buffer ("qkv"), or views
    of a flat buffer that start 4 bytes past a 16-byte boundary with row
    strides of d + 1 floats ("shifted": no TMA box could copy them as they
    are), and dout (b, h, n, d)."""
    if layout == "shifted":
        buf = torch.randn(3 * b * h * n * (d + 1) + 1, generator=g, device="cuda")
        size = b * h * n * (d + 1)
        views = [buf[1 + i * size:1 + (i + 1) * size].view(b, h, n, d + 1)[..., :d]
                 for i in range(3)]
        assert all(t.data_ptr() % 16 == 4 for t in views)
        q, k, v = views
    else:
        buf = torch.randn((b, n, 3, h, d), generator=g, device="cuda")
        q, k, v = (buf[:, :, i].transpose(1, 2) for i in range(3))
    do = torch.randn((b, h, n, d), generator=g, device="cuda")
    return q, k, v, do


def _seg(g, b, n, kind):
    if kind == "none":
        return None
    if kind == "interleaved":
        return torch.randint(0, 3, (b, n), generator=g, device="cuda", dtype=torch.int32)
    return (torch.arange(n, device="cuda") < max(1, n - 63)).int()[None].expand(b, n).contiguous()


def _card_check(g, shape, kind="none", layout="qkv", design="warpgroup"):
    """Forward with residuals, dK/dV and dQ on the card against the plain
    versions (atol 2e-5, l relative), the same bits on a second run, and one
    launch of each on ``design`` (``wg_launches``; the dK/dV's on the design
    the plan gives it, ``wg128_launches``)."""
    b, h, n, d = shape
    assert fa.fp32_plan(*shape)[0] == design
    keys128 = fa.fp32_plan(*shape)[4] == 128
    q, k, v, do = _inputs(g, b, h, n, d, layout)
    seg = _seg(g, b, n, kind)
    scale = d**-0.5
    ro, rl, rm = fa.flash_forward_plain(q, k, v, scale, seg)
    di = (ro * do).sum(-1).contiguous()
    counters = (fa.flash_attention, fa.flash_bwd_dkv, fa.flash_bwd_dq)
    before = [(w.launches, w.wg_launches) for w in counters]
    wide = fa.flash_bwd_dkv.wg128_launches

    def run():
        out, l, m = fa.flash_forward(q, k, v, scale, residuals=True, segment_ids=seg)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, rl, rm, di, scale, seg)
        dq = fa.flash_bwd_dq(q, k, v, do, rl, rm, di, scale, seg)
        return out, l, m, dk, dv, dq

    got = run()
    torch.cuda.synchronize()
    wg = design == "warpgroup"
    assert [(w.launches, w.wg_launches) for w in counters] == [(a + 1, c + wg)
                                                               for a, c in before]
    assert fa.flash_bwd_dkv.wg128_launches == wide + keys128
    assert all(torch.equal(x, y) for x, y in zip(got, run()))
    want_dk, want_dv = fa.flash_bwd_dkv_plain(q, k, v, do, rl, rm, di, scale, seg)
    want_dq = fa.flash_bwd_dq_plain(q, k, v, do, rl, rm, di, scale, seg)
    for name, x, want in (("out", got[0], ro), ("m", got[2], rm), ("dk", got[3], want_dk),
                          ("dv", got[4], want_dv), ("dq", got[5], want_dq)):
        torch.testing.assert_close(x, want, rtol=0, atol=ATOL, msg=name)
    torch.testing.assert_close(got[1], rl, rtol=ATOL, atol=0)


def _warpgroup_everywhere(monkeypatch):
    """The plan's crossover lowered to 1, so the warpgroup kernels run at
    shapes where the plan would take the cluster kernels."""
    monkeypatch.setattr(fa, "WG_MIN_N", 1)
    monkeypatch.setattr(fa, "WG_MIN_CTAS", 1)


@pytest.mark.gpu
@pytest.mark.parametrize("design", DKV_DESIGNS)
@pytest.mark.parametrize("n", [384, 768, 4096])
@pytest.mark.parametrize("kind", ["tail", "interleaved", "none"])
def test_wg_kernels_at_the_slide_shapes(cuda, monkeypatch, n, kind, design):
    """The slide baselines' heads, (1, 16, n, 64), on the warpgroup design,
    its dK/dV on either design."""
    _dkv_design(monkeypatch, design)
    _card_check(cuda, (1, 16, n, 64), kind)


@pytest.mark.gpu
@pytest.mark.parametrize("design", DKV_DESIGNS)
@pytest.mark.parametrize("shape", [(1, 16, 4000, 64), (1, 16, 4033, 64), (1, 2, 300, 64),
                                   (1, 3, 333, 64), (2, 3, 129, 64), (1, 2, 1, 64),
                                   (1, 1, 65, 64)], ids=str)
def test_wg_kernels_at_ragged_n(cuda, monkeypatch, shape, design):
    """n that is no multiple of the 32- and 64-row tiles (the last tiles
    ragged), with tail ids; below the crossover the design is forced. On
    128-key CTAs n = 4,000, 300 and 1 leave the last CTA's second warpgroup
    no key below n; n = 4,033 and 65 give it one."""
    _warpgroup_everywhere(monkeypatch)
    _dkv_design(monkeypatch, design)
    _card_check(cuda, shape, "tail")


@pytest.mark.gpu
@pytest.mark.parametrize("design", DKV_DESIGNS)
@pytest.mark.parametrize("d", [32, 20, 128])
def test_wg_kernels_at_other_head_widths(cuda, monkeypatch, d, design):
    """d = 32 and d = 20 (tiles of 32 columns, zero past d) on the
    warpgroup design, its dK/dV on either design; d = 128 stays on the
    cluster kernels (the plan), same checks."""
    _dkv_design(monkeypatch, design)
    _card_check(cuda, (1, 16, 768, d), "tail", design="warpgroup" if d <= 64 else "cluster")


@pytest.mark.gpu
@pytest.mark.parametrize("design", DKV_DESIGNS)
@pytest.mark.parametrize("shape", [(1, 16, 384, 64), (1, 16, 768, 36), (2, 8, 700, 64)],
                         ids=str)
def test_wg_kernels_on_inputs_tma_cannot_take(cuda, monkeypatch, shape, design):
    """Views 4 bytes past a 16-byte boundary with rows of d + 1 floats (and
    d = 36): no TMA box could copy them; the split pass reads them with
    plain loads, and the kernels copy its output by TMA."""
    _dkv_design(monkeypatch, design)
    _card_check(cuda, shape, "tail", layout="shifted")


@pytest.mark.gpu
@pytest.mark.parametrize("design", DKV_DESIGNS)
@pytest.mark.parametrize("n", [384, 4096])
def test_wg_autograd_matches_plain_autograd(cuda, monkeypatch, n, design):
    """torch.autograd.grad through flash_attention with a mask (one split
    pass and both backward kernels, dK/dV on either design) against
    autograd of the plain segment forward, on the views of one qkv buffer."""
    _dkv_design(monkeypatch, design)
    qkv = torch.randn((1, n, 3, 16, 64), generator=cuda, device="cuda", requires_grad=True)
    cot = torch.randn((1, 16, n, 64), generator=cuda, device="cuda")
    mask = torch.arange(n, device="cuda") < n - 37
    seg = mask.to(torch.int32)[None]

    def grad(attend):
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        return torch.autograd.grad((attend(q, k, v) * cot).sum(), qkv)[0]

    before = tuple(w.wg_launches for w in (fa.flash_attention, fa.flash_bwd_dkv, fa.flash_bwd_dq))
    wide = fa.flash_bwd_dkv.wg128_launches
    got = grad(lambda q, k, v: fa.flash_attention(q, k, v, 0.125, mask))
    assert tuple(w.wg_launches for w in (fa.flash_attention, fa.flash_bwd_dkv,
                                         fa.flash_bwd_dq)) == tuple(x + 1 for x in before)
    assert fa.flash_bwd_dkv.wg128_launches == wide + (design == "keys128")
    want = grad(lambda q, k, v: fa.flash_forward_plain(q, k, v, 0.125, seg)[0])
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)
