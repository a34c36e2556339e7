"""The bf16 flash kernels' 64-row warpgroup tiles.

The three kernels (``csrc/flash_attention_bf16.cu``, ``csrc/flash_attention_
bwd_bf16.cu::flash_bwd_dkv_bf16`` and ``::flash_bwd_dq_bf16``) own blocks of
64 rows, one warpgroup's ``wgmma`` tile, one CTA each, and walk the other
side in tiles of 64 through a two-stage ring (``bf16_plan``); inputs that
TMA cannot take run a variant that stages the same tiles by plain loads
(``tma_ok`` says which). On the CPU:

  (a) ``bf16_plan`` at every shape the card tests launch, and its limits; the
      plan a bf16 dQ (and every bf16 launch) hands its C entry point;
  (b) ``tma_ok``: which views take TMA;
  (c) the tiles' maps (``csrc/flash_wgmma.cuh``): the 128-byte swizzle, the
      wgmma accumulator and the register A operand, as bijections, and the
      accumulator packed into the A operand (``pack_a``) as the A layout;
  (d) a numpy model of the forward's rounding points (64-key tiles, p rounded
      to bf16 against the running max after each tile) held to the JAX
      library's Pallas kernel in interpret mode on bf16 inputs, within
      ``2**-7 * max|ref|`` as the plain versions are
      (``test_torch_port_flash_bf16.py``), l and m within 1e-5; and one of
      dQ's (64-key tiles, p from 2^x with m log2(e) and 1 / l, ds rounded to
      bf16 per tile, dq summed in fp32 across tiles and rounded once) held
      to the library's ``_flash_attention_bwd_dq`` within ``2**-7 * max|ref|
      + 1e-5``.

On the card (``gpu`` marker): the three kernels against their plain bf16 versions
at n = 1, 63, 64, 65, 127, 129, 300, 768, 4,096 and d = 32 / 64 / 128, with
segment ids (tail-padded and interleaved), at d % 8 != 0 and on a misaligned
view (the plain-load variant), the same bits on two runs, the launch counts:

    python -m pytest --noconftest tests/test_torch_port_flash_bf16_tiles.py -m gpu
"""

import contextlib
import types

import numpy as np
import pytest
import torch

from mclstexp_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)

REL = 2.0**-7
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453


# --- (a) the plan -----------------------------------------------------------------------------

@pytest.mark.parametrize("shape,ctas", [
    ((1, 8, 32, 64), 8),        # eval sweep
    ((1, 8, 128, 64), 16),      # spot tower training
    ((1, 8, 66, 64), 16),       # the training fold's remainder batch
    ((1, 8, 300, 64), 40),      # ragged
    ((1, 8, 128, 32), 16),
    ((1, 8, 128, 128), 16),
    ((1, 16, 384, 64), 96),     # HisToGene slides
    ((1, 16, 768, 64), 192),
    ((1, 16, 4096, 64), 1024),  # the whole slide
    ((1, 2, 1, 64), 2),
    ((2, 3, 66, 32), 12),
    ((1, 4, 300, 128), 20),
    ((1, 2, 129, 64), 6),
    ((1, 1, 1000, 64), 16),
    ((1, 2, 768, 64), 24),
    ((1, 2, 4096, 64), 128),
    ((2, 1, 600, 64), 20),
])
def test_bf16_plan_at_the_launched_shapes(shape, ctas):
    """One CTA per block of 64 rows, none split: b * h * ceil(n / 64)."""
    b, h, n, _ = shape
    assert fa.bf16_plan(*shape) == (64, 1, ctas, 2)
    assert ctas == b * h * -(-n // 64)


# every shape the card tests launch the bf16 dQ at: the tile edges and the
# flagship's and slides' shapes of test_torch_port_flash_bf16.py::
# test_bf16_kernels_at_tile_edges_and_the_card_shapes (then d % 8 != 0 and
# misaligned views), the whole slide, the flagship fold's remainder batch and
# the HisToGene folds' padded slides (tests/test_torch_port_card_*.py)
DQ_SHAPES = ([(1, 2, n, d) for d in (32, 64, 128) for n in (1, 63, 64, 65, 127, 129)]
             + [(1, 3, 65, 36), (1, 2, 300, 20), (2, 2, 129, 64), (1, 2, 70, 100)]
             + [(1, 8, 32, 64), (1, 8, 128, 64), (1, 8, 300, 64), (1, 8, 128, 32),
                (1, 8, 128, 128), (1, 16, 384, 64), (1, 16, 768, 64), (1, 16, 4096, 64),
                (1, 8, 66, 64), (1, 16, 640, 64)])


def _entry_plan(monkeypatch, dtype, shape):
    """The (rows, split) that ``_launch`` hands a dQ C entry point for q of
    ``shape`` in ``dtype`` (a stand-in entry point records them)."""
    seen = []

    def entry(*args):  # pointers, ids, strides, b, h, n, d, rows, split, scale, stream
        seen.append(args[-4:-2])
        return 0

    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    q = torch.empty(shape, dtype=dtype)
    stats = torch.empty(shape[:3])
    fa._launch(entry, "flash_bwd_dq", (q, q, q, q, stats, stats, stats, q), None,
               (q, q, q, q, q), 0.125)
    return seen[0]


@pytest.mark.parametrize("shape", DQ_SHAPES, ids=str)
def test_bf16_dq_launches_under_bf16_plan(monkeypatch, shape):
    """A bf16 dQ runs under ``bf16_plan`` (64 rows, split 1, one CTA per
    block of 64 queries) at every shape the card tests launch it; fp32 keeps
    ``cluster_plan``."""
    b, h, n, _ = shape
    assert fa.bf16_plan(*shape) == (64, 1, b * h * -(-n // 64), 2)
    assert _entry_plan(monkeypatch, torch.bfloat16, shape) == (64, 1)
    assert _entry_plan(monkeypatch, torch.float32, shape) == fa.cluster_plan(*shape)[:2]


@pytest.mark.parametrize("shape", [(1, 1, 1, 0), (1, 1, 1, 129), (1, 1, 0, 64), (0, 1, 8, 64),
                                   (1, 1, 65535 * 64 + 1, 64)])
def test_bf16_plan_limits_raise(shape):
    with pytest.raises(ValueError):
        fa.bf16_plan(*shape)
    assert fa.bf16_plan(1, 1, 65535 * 64, 64)[0] == 64


# --- (b) TMA or the plain-load variant --------------------------------------------------------

def _views(b, n, h, d, offset=0, width=None):
    buf = torch.zeros((b, n, 3, h, width or d), dtype=torch.bfloat16)
    return [buf[:, :, i, :, offset:offset + d].transpose(1, 2) for i in range(3)]


def _rows_64_apart():
    q = torch.zeros((1, 4, 70, 64), dtype=torch.bfloat16)[:, :, 3:67]
    return q, q, q


def _extent_one(n_stride):
    """A view whose b and h have extent 1 and odd strides: TMA never steps
    along them, so only the n stride counts."""
    odd = torch.zeros(1024, dtype=torch.bfloat16).as_strided((1, 1, 10, 64), (7, 3, 64, 1))
    return odd.as_strided((1, 1, 10, 64), (7, 3, n_stride, 1)), odd, odd


@pytest.mark.parametrize("views,want", [
    (lambda: _views(2, 66, 8, 64), True),          # the qkv buffer's views
    (lambda: _views(1, 1, 1, 64), True),
    (lambda: _views(1, 66, 8, 36), False),         # d % 8 != 0
    (lambda: _views(1, 66, 8, 64, 1, 72), False),  # base 2 bytes off 16
    (lambda: _views(1, 66, 8, 64, 8, 72), True),   # 16 bytes off: aligned
    (_rows_64_apart, True),                        # rows 64 values apart
    (lambda: _extent_one(64), True),
    (lambda: _extent_one(60), False),              # an n stride of 120 bytes
], ids=["qkv", "one-row", "d36", "base+2", "base+16", "rows-64-apart", "extent-1",
        "n-stride-60"])
def test_tma_takes_aligned_views_only(views, want):
    assert fa.tma_ok(*views()) is want


# --- (c) the tiles' maps ----------------------------------------------------------------------

def swizzled(r, c):
    """csrc/flash_wgmma.cuh ``swizzled``: byte offset of (r, c) in a tile."""
    return (c >> 6) * 8192 + r * 128 + ((((c >> 3) & 7) ^ (r & 7)) << 4) + ((c & 7) << 1)


def accumulator(w, g, t, i):
    """(row, column) of register i of thread (warp w, lane 4g + t) in a
    wgmma m64nN accumulator."""
    return 16 * w + g + 8 * ((i >> 1) & 1), 8 * (i >> 2) + 2 * t + (i & 1)


@pytest.mark.parametrize("dp", [64, 128])
def test_swizzle_is_a_bijection_of_16_byte_chunks(dp):
    offsets = {swizzled(r, c) for r in range(64) for c in range(dp)}
    assert offsets == set(range(0, 64 * dp * 2, 2))
    for r in range(64):
        for c in range(0, dp, 8):  # a chunk of 8 values stays whole and 16-byte aligned
            at = swizzled(r, c)
            assert at % 16 == 0 and [swizzled(r, c + e) for e in range(8)] == list(
                range(at, at + 16, 2))
    # the 8 rows of a column chunk fall in 8 different 16-byte bank groups
    for c in range(0, dp, 8):
        for r0 in range(0, 64, 8):
            assert len({swizzled(r, c) % 128 for r in range(r0, r0 + 8)}) == 8


@pytest.mark.parametrize("n_cols", [64, 128])
def test_accumulator_and_a_operand_maps(n_cols):
    cells = {accumulator(w, g, t, i) for w in range(4) for g in range(8) for t in range(4)
             for i in range(n_cols // 2)}
    assert cells == {(r, c) for r in range(64) for c in range(n_cols)}
    # pack_a: word x of slice kk holds registers 8kk + 2x, 8kk + 2x + 1, which
    # must be the A fragment's (g, 2t), (g + 8, 2t), (g, 2t + 8), (g + 8, 2t + 8)
    # of rows 16w.. and columns 16kk.. (PTX ISA, wgmma register A)
    for w in range(4):
        for g in range(8):
            for t in range(4):
                for kk in range(4):
                    for x in range(4):
                        want_row = 16 * w + g + 8 * (x & 1)
                        want_col = 16 * kk + 2 * t + 8 * (x >> 1)
                        got = [accumulator(w, g, t, 8 * kk + 2 * x + e) for e in range(2)]
                        assert got == [(want_row, want_col), (want_row, want_col + 1)]


# --- (d) the forward's rounding points against the library ------------------------------------

def _bf16(x):
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).bfloat16().float().numpy()


def forward_model(q, k, v, scale, seg):
    """The redesigned forward on the values (b, h, n, d) fp32 arrays holding
    bf16 values: an online softmax over the tiles of 64 keys in order (fp32
    scores in log2 units, p rounded to bf16 against the running max after
    each tile, l summing the fp32 p); out normalized in fp32 and rounded to
    bf16 once. Returns (out, l, m)."""
    with np.errstate(invalid="ignore", divide="ignore"):  # -inf - -inf on masked rows
        return _forward_model(q, k, v, scale, seg)


def _forward_model(q, k, v, scale, seg):
    n = q.shape[2]
    tiles = -(-n // 64)
    s_all = np.matmul(q, np.swapaxes(k, -1, -2), dtype=np.float32) * np.float32(scale * LOG2E)
    if seg is not None:
        same = seg[:, None, :, None] == seg[:, None, None, :]
        s_all = np.where(same, s_all, -np.inf).astype(np.float32)
    m = np.full(q.shape[:3], -np.inf, np.float32)
    l = np.zeros(q.shape[:3], np.float32)
    o = np.zeros(q.shape, np.float32)
    for tile in range(tiles):
        s = s_all[..., tile * 64:(tile + 1) * 64]
        m_new = np.maximum(m, s.max(-1))
        alpha = np.where(m == -np.inf, 0, np.exp2(m - m_new)).astype(np.float32)
        p = np.where(s == -np.inf, 0, np.exp2(s - m_new[..., None])).astype(np.float32)
        l = l * alpha + p.sum(-1, dtype=np.float32)
        o = o * alpha[..., None] + np.matmul(_bf16(p), v[..., tile * 64:(tile + 1) * 64, :],
                                             dtype=np.float32)
        m = m_new
    return _bf16(o / l[..., None]), l, m * np.float32(LN2)


@pytest.mark.parametrize("n", [1, 63, 64, 65, 300])
@pytest.mark.parametrize("kind", ["none", "tail", "interleaved"])
def test_forward_model_matches_the_library(n, kind):
    import jax.numpy as jnp
    from test_torch_port_flash_grad import _library

    lib, interpret = _library()
    r = np.random.default_rng(100 + n)
    q, k, v = (_bf16(r.normal(size=(1, 2, n, 64))) for _ in range(3))
    seg = None
    if kind == "tail":
        seg = (np.arange(n) < max(1, n - 7)).astype(np.int32)[None]
    elif kind == "interleaved":
        seg = r.integers(0, 3, size=(1, n)).astype(np.int32)
    if seg is None:
        blocks = lib.BlockSizes(block_q=n, block_k_major=n, block_k=n, block_b=1)
        ids, inputs = None, (q, k, v)
    else:
        # the library takes ids only with key blocks of 128: pad the keys and
        # queries to a multiple of 128 in a segment of their own, which no
        # real row sees, and compare the real rows
        pad = -(-n // 128) * 128
        seg_p = np.concatenate([seg, np.full((1, pad - n), 7, np.int32)], axis=1)
        ids = lib.SegmentIds(q=jnp.asarray(seg_p), kv=jnp.asarray(seg_p))
        inputs = tuple(np.pad(x, ((0, 0), (0, 0), (0, pad - n), (0, 0))) for x in (q, k, v))
        blocks = lib.BlockSizes(block_q=128, block_k_major=128, block_k=128, block_b=1)
    with interpret():
        o, l, m = lib._flash_attention(*(jnp.asarray(x).astype(jnp.bfloat16) for x in inputs),
                                       None, ids, True, False, 0.125, blocks, False)
    o, l, m = (np.asarray(x.astype(jnp.float32))[:, :, :n] for x in (o, l, m))
    l, m = (x[..., 0] if x.ndim == 4 else x for x in (l, m))
    out, lm, mm = forward_model(q, k, v, 0.125, seg)
    err = np.abs(out - o).max()
    assert err <= REL * np.abs(o).max(), err
    np.testing.assert_allclose(lm, l, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(mm, m, rtol=1e-5, atol=1e-5)


def test_forward_model_is_the_plain_version_up_to_rounding_order():
    """The model and ``flash_forward_plain`` share every cast; they differ
    only in which running max p is rounded against."""
    r = np.random.default_rng(5)
    q, k, v = (_bf16(r.normal(size=(1, 2, 200, 64))) for _ in range(3))
    out, l, m = forward_model(q, k, v, 0.125, None)
    po, pl, pm = fa.flash_forward_plain(*(torch.from_numpy(x).bfloat16() for x in (q, k, v)), 0.125)
    assert np.abs(out - po.float().numpy()).max() <= REL * np.abs(po.float().numpy()).max()
    np.testing.assert_allclose(l, pl.numpy(), rtol=1e-5)
    np.testing.assert_allclose(m, pm.numpy(), rtol=0, atol=1e-5)


def dq_model(q, k, v, do, l, m, di, scale, seg):
    """The redesigned dQ on the values: (b, h, n, d) fp32 arrays holding
    bf16 values, l, m, di (b, h, n) fp32. Per tile of 64 keys in order: s =
    q k^T and dp = do v^T in fp32, p = 2^(s scale log2(e) - m log2(e)) (0
    across segments), ds = p ((dp - di) scale / l) in fp32 and rounded to
    bf16, dq += ds k summed in fp32; dq rounded to bf16 once."""
    with np.errstate(over="ignore"):  # 2^x of masked entries before they are zeroed
        return _dq_model(q, k, v, do, l, m, di, scale, seg)


def _dq_model(q, k, v, do, l, m, di, scale, seg):
    n = q.shape[2]
    f32 = np.float32
    s_all = np.matmul(q, np.swapaxes(k, -1, -2), dtype=f32)
    dp_all = np.matmul(do, np.swapaxes(v, -1, -2), dtype=f32)
    m2 = (m * f32(LOG2E)).astype(f32)[..., None]
    sl = (f32(scale) / l).astype(f32)[..., None]
    same = None if seg is None else seg[:, None, :, None] == seg[:, None, None, :]
    dq = np.zeros(q.shape, f32)
    for tile in range(-(-n // 64)):
        keys = slice(tile * 64, (tile + 1) * 64)
        arg = (s_all[..., keys] * f32(scale * LOG2E) - m2).astype(f32)
        if same is not None:
            arg = np.where(same[..., keys], arg, -np.inf).astype(f32)
        ds = np.exp2(arg) * ((dp_all[..., keys] - di[..., None]) * sl)
        dq += np.matmul(_bf16(ds), k[..., keys, :], dtype=f32)
    return _bf16(dq)


@pytest.mark.parametrize("n", [1, 63, 64, 65, 300])
@pytest.mark.parametrize("kind", ["none", "tail", "interleaved"])
def test_dq_model_matches_the_library(n, kind):
    """The model against ``_flash_attention_bwd_dq`` on bf16 inputs in
    interpret mode (l, m from the library's forward, di = rowsum(o * do) as
    the library's backward forms it), within 2**-7 * max|ref| + 1e-5. The
    library takes blocks of 128 keys only (its l and m come in lanes of
    128), so queries and keys are padded to a multiple of 128 in a segment
    of their own that no real row sees; "none" gives every real row one id,
    which is no mask on the real rows, and the model gets no ids."""
    import jax.numpy as jnp
    from test_torch_port_flash_grad import _library

    lib, interpret = _library()
    r = np.random.default_rng(200 + n)
    q, k, v, do = (_bf16(r.normal(size=(1, 2, n, 64))) for _ in range(4))
    seg = None
    if kind == "tail":
        seg = (np.arange(n) < max(1, n - 7)).astype(np.int32)[None]
    elif kind == "interleaved":
        seg = r.integers(0, 3, size=(1, n)).astype(np.int32)
    pad = -(-n // 128) * 128
    real = np.zeros((1, n), np.int32) if seg is None else seg
    seg_p = jnp.asarray(np.concatenate([real, np.full((1, pad - n), 7, np.int32)], axis=1))
    ids = lib.SegmentIds(q=seg_p, kv=seg_p)
    jq, jk, jv, jdo = (jnp.asarray(np.pad(x, ((0, 0), (0, 0), (0, pad - n), (0, 0))))
                       .astype(jnp.bfloat16) for x in (q, k, v, do))
    blocks = lib.BlockSizes(block_q=128, block_k_major=128, block_k=128, block_b=1)
    with interpret():
        o, l, m = lib._flash_attention(jq, jk, jv, None, ids, True, False, 0.125, blocks, False)
        di = jnp.sum(o.astype(jnp.float32) * jdo.astype(jnp.float32), axis=-1)
        dq, _ = lib._flash_attention_bwd_dq(
            jq, jk, jv, None, ids, l, m, jdo, di, block_q_major=128, block_k_major=128,
            block_k=128, sm_scale=0.125, causal=False, mask_value=lib.DEFAULT_MASK_VALUE,
            debug=False)
    assert dq.dtype == jnp.bfloat16
    ref = np.asarray(dq.astype(jnp.float32))[:, :, :n]
    l, m, di = (np.asarray(x, np.float32)[:, :, :n] for x in (l, m, di))
    got = dq_model(q, k, v, do, l, m, di, 0.125, seg)
    err = np.abs(got - ref).max()
    assert err <= REL * np.abs(ref).max() + 1e-5, err


def test_dq_model_is_the_plain_version_up_to_rounding_order():
    """The model and ``flash_bwd_dq_plain`` share every cast (ds to bf16, dq
    once); they differ only in how fp32 sums are ordered."""
    r = np.random.default_rng(6)
    q, k, v, do = (_bf16(r.normal(size=(1, 2, 200, 64))) for _ in range(4))
    seg = r.integers(0, 2, size=(1, 200)).astype(np.int32)
    tq, tk, tv, tdo = (torch.from_numpy(x).bfloat16() for x in (q, k, v, do))
    tseg = torch.from_numpy(seg)
    o, l, m = fa.flash_forward_plain(tq, tk, tv, 0.125, tseg)
    di = (o.float() * tdo.float()).sum(-1)
    want = fa.flash_bwd_dq_plain(tq, tk, tv, tdo, l, m, di, 0.125, tseg).float().numpy()
    got = dq_model(q, k, v, do, l.numpy(), m.numpy(), di.numpy(), 0.125, seg)
    assert np.abs(got - want).max() <= REL * np.abs(want).max()


# --- on the card ------------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.Generator(device="cuda").manual_seed(11)


def _inputs(g, b, h, n, d, layout="qkv"):
    """bf16 q, k, v as views of one (b, n, 3, h, d) buffer ("qkv"), of a
    buffer one element wider whose views start 2 bytes past 16 ("shifted"),
    and dout (b, h, n, d)."""
    width = d + 1 if layout == "shifted" else d
    buf = torch.randn((b, n, 3, h, width), generator=g, device="cuda").bfloat16()
    off = 1 if layout == "shifted" else 0
    q, k, v = (buf[:, :, i, :, off:off + d].transpose(1, 2) for i in range(3))
    do = torch.randn((b, h, n, d), generator=g, device="cuda").bfloat16()
    return q, k, v, do


def _seg(g, b, n, kind):
    if kind == "none":
        return None
    if kind == "interleaved":
        return torch.randint(0, 3, (b, n), generator=g, device="cuda", dtype=torch.int32)
    real = (torch.arange(n, device="cuda") < max(1, n - 63)).int()
    return real[None].expand(b, n).contiguous()


def _close(got, want, name):
    assert got.dtype == torch.bfloat16, name
    err = (got.float() - want.float()).abs().max().item()
    assert err <= REL * want.float().abs().max().item() + 1e-5, (name, err)


def _card_check(g, shape, kind="none", layout="qkv"):
    b, h, n, d = shape
    q, k, v, do = _inputs(g, b, h, n, d, layout)
    seg = _seg(g, b, n, kind)
    scale = d**-0.5
    ro, rl, rm = fa.flash_forward_plain(q, k, v, scale, seg)
    di = (ro.float() * do.float()).sum(-1).contiguous()
    counts = lambda: (fa.flash_attention.bf16_launches,  # noqa: E731
                      fa.flash_bwd_dkv.bf16_launches, fa.flash_bwd_dq.bf16_launches,
                      fa.flash_attention.bf16_segment_launches,
                      fa.flash_bwd_dq.bf16_segment_launches)
    before = counts()

    def run():
        out, l, m = fa.flash_forward(q, k, v, scale, residuals=True, segment_ids=seg)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, rl, rm, di, scale, seg)
        dq = fa.flash_bwd_dq(q, k, v, do, rl, rm, di, scale, seg)
        return out, l, m, dk, dv, dq

    got = run()
    torch.cuda.synchronize()
    ids = seg is not None
    assert counts() == (before[0] + 1, before[1] + 1, before[2] + 1, before[3] + ids,
                        before[4] + ids)
    assert all(torch.equal(x, y) for x, y in zip(got, run()))
    want_dk, want_dv = fa.flash_bwd_dkv_plain(q, k, v, do, rl, rm, di, scale, seg)
    _close(got[0], ro, "out")
    torch.testing.assert_close(got[1], rl, rtol=1e-5, atol=0)
    torch.testing.assert_close(got[2], rm, rtol=0, atol=1e-5)
    _close(got[3], want_dk, "dk")
    _close(got[4], want_dv, "dv")
    _close(got[5], fa.flash_bwd_dq_plain(q, k, v, do, rl, rm, di, scale, seg), "dq")
    return fa.tma_ok(q, k, v, do)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("n", [1, 63, 64, 65, 127, 129, 300, 768, 4096])
def test_wg_kernels_match_plain(cuda, n, d):
    assert _card_check(cuda, (1, 2, n, d))


@pytest.mark.gpu
@pytest.mark.parametrize("n,d", [(65, 64), (129, 32), (300, 64), (768, 128), (4096, 64)])
@pytest.mark.parametrize("kind", ["tail", "interleaved"])
def test_wg_kernels_with_segment_ids(cuda, n, d, kind):
    _card_check(cuda, (1, 2, n, d), kind)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,layout", [((1, 3, 65, 36), "qkv"), ((1, 2, 300, 20), "qkv"),
                                          ((2, 2, 129, 64), "shifted"),
                                          ((1, 2, 70, 100), "shifted")])
def test_wg_kernels_plain_load_variant(cuda, shape, layout):
    """d % 8 != 0 or a view 2 bytes past a 16-byte boundary: the variant
    that stages the tiles by 2-byte loads, same results."""
    assert not _card_check(cuda, shape, "tail" if shape[2] == 129 else "none", layout)


@pytest.mark.gpu
def test_wg_kernels_at_a_batch(cuda):
    """b > 1: 2 x 1 heads at n = 600 (10 tiles, 20 blocks), interleaved ids."""
    assert _card_check(cuda, (2, 1, 600, 64), "interleaved")
