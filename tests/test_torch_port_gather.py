"""Port parity of the data-movement kernels' designs, on the CPU.

A CUDA kernel cannot run here, so its index arithmetic is modelled in numpy
on the raw bits, block by block and thread by thread as the launch plan
(``row_shift.shift_plan``, ``patches.patch_plan``) lays them out, and the
model is held to the JAX package on the same inputs, bit for bit:
  * ``shift_cols_band`` (the column shear): the band's column staged in
    "shared memory" by 16-byte chunks, each output element read at row
    r - k[s], 16-byte stores; against JAX ``row_shift(..., interpret=True)``
    on the transposed view. Every output chunk is written once and every
    shared-memory read was loaded first.
  * ``realign::load`` (``csrc/realign.cuh``), which the two 16-byte
    gathers share: aligned 16-byte words, the window shifted right by the
    start's residue (word selects, then a funnel shift), edge masks; every
    word read holds a byte of the buffer.
  * ``shift_rows16`` (the row shears): each 16-byte output chunk loaded
    from k * C elements back; against JAX ``row_shift`` on the image.
  * ``gather_rows16`` (the patch gather), and ``gather_bytes`` at odd P *
    C; against JAX ``extract_patches_np``, with the slide at every address
    residue mod 16.
The factored Paeth shears (``augment.paeth_shears``), which the card's
timings and the main path share, are held to the shifts JAX
``rotate_batch_paeth`` hands its kernel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mclstexp_tpu.ops import augment as jax_augment
from mclstexp_tpu.ops import pallas_shift
from mclstexp_tpu.ops.patches import extract_patches_np as jax_extract_patches_np
from mclstexp_tpu_torch.ops import augment
from mclstexp_tpu_torch.ops.patches import patch_plan
from mclstexp_tpu_torch.ops.row_shift import BAND_SMEM_MAX, row_shift, shift_plan

torch.set_num_threads(1)

I32_MIN, I32_MAX = -2**31, 2**31 - 1


# -- the Paeth shears -------------------------------------------------------


@pytest.mark.parametrize("size", [16, 224])
def test_paeth_shears_are_the_shifts_jax_rotation_passes(rng, monkeypatch, size):
    """The shears of 64 drawn angles (and the quarter-turn edges) equal the
    three shift arrays JAX ``rotate_batch_paeth`` passes to its kernel, in
    order: shear_x, shear_y (the column shear), shear_x."""
    seen = []

    def record(imgs, shifts, interpret=False):
        seen.append(np.asarray(shifts))
        return imgs

    monkeypatch.setattr(pallas_shift, "row_shift", record)
    angles = np.concatenate([[0.0, 45.0, -45.0, 44.9, 135.0, -179.9, 90.0],
                             rng.uniform(-180, 180, size=57)]).astype(np.float32)
    jax_augment.rotate_batch_paeth(jnp.zeros((64, size, size, 1)), jnp.asarray(angles),
                                   interpret=True)
    k, shear_x, shear_y = augment.paeth_shears(torch.from_numpy(angles), size)
    assert shear_x.dtype == shear_y.dtype == torch.int32 and shear_x.shape == (64, size)
    assert len(seen) == 3
    for got, want in zip((shear_x, shear_y, shear_x), seen):
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(k.numpy(), np.mod(np.round(angles / 90.0), 4))
    # neighbouring columns' shifts differ by at most one, |k| <= (size - 1) / 2 * sin 45
    assert int(shear_y.diff(dim=1).abs().max()) <= 1
    assert int(shear_y.abs().max()) <= round((size - 1) / 2 * 2**-0.5)


# -- row_shift: the plan ----------------------------------------------------


@pytest.mark.parametrize("itemsize,band,blocks", [(4, 16, 128 * 14), (2, 32, 128 * 7)])
def test_shift_plan_at_the_flagship(itemsize, band, blocks):
    """The column shear of (128, 224, 224, 3) takes the band path: a
    192-byte band row, 12 chunk lanes x 21 rows = 252 threads, 43,008 bytes
    of shared memory; the row shears take shift_rows."""
    assert shift_plan(128, 224, 224, 3, itemsize, True) == (
        "shift_cols_band", band, 252, 43_008, blocks)



@pytest.mark.parametrize("itemsize,threads", [(4, 192), (2, 96)])
def test_shift_plan_row_layout(itemsize, threads):
    """The row shears of (128, 224, 224, 3) take shift_rows16, one block per
    memory row, a thread per 16-byte chunk in whole warps (168 or 84
    chunks); rows of no whole chunks or unaligned buffers take shift_rows."""
    assert shift_plan(128, 224, 224, 3, itemsize, False) == (
        "shift_rows16", 0, threads, 0, 128 * 224)
    assert shift_plan(2, 16, 1000, 4, itemsize, False).threads == 256  # chunks loop
    for args in ((2, 16, 38, 3, itemsize, False), (2, 16, 40, 3, itemsize, False, False)):
        assert shift_plan(*args) == ("shift_rows", 0, 256, 0, 32)


@pytest.mark.parametrize("args,why", [
    ((1, 4096, 64, 3, 4, True), "the band's column exceeds shared memory"),
    ((2, 16, 38, 3, 4, True), "a memory row of 456 bytes is no multiple of 16"),
    ((2, 16, 30, 3, 2, True), "a memory row of 180 bytes is no multiple of 16"),
    ((2, 16, 40, 3, 4, False), "unaligned buffers"),
    ((2, 16, 40, 80, 4, True), "a pixel wider than a band row"),
])
def test_shift_plan_falls_back_to_the_per_row_kernel(args, why):
    *shape, itemsize, aligned = args
    assert shift_plan(*shape, itemsize, True, aligned=aligned) == (
        "shift_cols", 0, 256, 0, shape[0] * shape[1]), why


@pytest.mark.parametrize("shape", [(128, 224, 224, 3), (2, 16, 40, 3), (3, 100, 36, 4),
                                   (1, 1024, 64, 3), (2, 7, 8, 1), (1, 300, 20, 2)])
@pytest.mark.parametrize("itemsize", [4, 2])
def test_shift_plan_bands_cover_every_pixel_once_within_the_limits(shape, itemsize):
    batch, rows, row_px, c = shape
    plan = shift_plan(batch, rows, row_px, c, itemsize, True)
    assert plan.kernel == "shift_cols_band"
    nbands = -(-row_px // plan.band_px)
    assert plan.blocks == batch * nbands
    starts = [i * plan.band_px for i in range(nbands)]
    widths = [min(plan.band_px, row_px - s) for s in starts]
    assert sum(widths) == row_px and starts[-1] + widths[-1] == row_px
    row_bytes = [wd * c * itemsize for wd in widths]
    assert all(rb % 16 == 0 for rb in row_bytes) and max(row_bytes) <= 192
    lanes = plan.band_px * c * itemsize // 16
    assert plan.threads % lanes == 0 and plan.threads <= 256
    assert plan.smem_bytes == rows * plan.band_px * c * itemsize <= BAND_SMEM_MAX


# -- row_shift: the band kernel's model -------------------------------------


def _bits(x: torch.Tensor) -> np.ndarray:
    """The raw words of a float32 or bfloat16 tensor."""
    return x.view(torch.int32 if x.dtype == torch.float32 else torch.int16).numpy()


def _shift_cols_band_model(t_in: np.ndarray, shifts: np.ndarray, plan) -> np.ndarray:
    """shift_cols_band on the raw words of T (B, rows, row_px, C), block by
    block and thread by thread: T_out[b, r, s] = T_in[b, r - k[b, s], s]."""
    batch, rows, row_px, ch = t_in.shape
    words = t_in.reshape(batch, rows, row_px * ch)
    v = 16 // t_in.itemsize
    out = np.zeros_like(words)
    writes = np.zeros(words.shape, np.int64)
    nbands = -(-row_px // plan.band_px)
    lanes = plan.band_px * ch // v
    rstep = plan.threads // lanes
    half = rows // 2
    for block in range(plan.blocks):
        b, s0 = block // nbands, block % nbands * plan.band_px
        band_elems = min(plan.band_px, row_px - s0) * ch
        chunks = band_elems // v
        assert chunks * v == band_elems
        smem = np.zeros(plan.smem_bytes // t_in.itemsize, words.dtype)
        loaded = np.zeros(smem.shape, bool)
        for t in range(plan.threads):  # 16-byte cp.async of the band's column
            j = t % lanes
            for r in range(t // lanes, rows, rstep) if j < chunks else ():
                dst = slice(r * band_elems + j * v, r * band_elems + (j + 1) * v)
                smem[dst] = words[b, r, s0 * ch + j * v:s0 * ch + (j + 1) * v]
                loaded[dst] = True
        for t in range(plan.threads):  # after the barrier: 16-byte stores
            j = t % lanes
            if j >= chunks:
                continue
            e = j * v + np.arange(v)
            k = np.clip(shifts[b, s0 + e // ch], -half, half)
            for r in range(t // lanes, rows, rstep):
                sr = r - k
                ok = (sr >= 0) & (sr < rows)
                idx = np.where(ok, sr * band_elems + e, 0)
                assert loaded[idx[ok]].all()
                col = slice(s0 * ch + j * v, s0 * ch + (j + 1) * v)
                out[b, r, col] = np.where(ok, smem[idx], 0)
                writes[b, r, col] += 1
    assert (writes == 1).all()
    return out.reshape(t_in.shape)


def _shifts_with_clamp_edges(rng, b, n, w):
    s = rng.integers(-w, w + 1, size=(b, n)).astype(np.int32)
    edges = np.array([0, w // 2, -(w // 2), w // 2 + 1, -(w // 2) - 1, w, -w, 3 * w])
    s.reshape(-1)[: len(edges)] = edges
    return s


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["paeth", "random_rows16_px40", "random_rows24_px8"])
def test_band_kernel_model_matches_jax_row_shift(rng, dtype, case):
    """The model of shift_cols_band on T (B, rows, row_px, C) equals JAX's
    row_shift on the view T.transpose(1, 2): a square batch at the Paeth
    shears of drawn angles (one band a row), and random shifts with the
    clamp edges over several bands with a narrower last one (row_px 40) and
    with the band as wide as the row (row_px 8)."""
    if case == "paeth":
        batch, rows, row_px = 6, 16, 16
        angles = torch.from_numpy(rng.uniform(-180, 180, size=batch).astype(np.float32))
        shifts = augment.paeth_shears(angles, 16)[2].numpy()
    else:
        batch, rows, row_px = 3, *(int(f.lstrip("rowspx")) for f in case.split("_")[1:])
        shifts = _shifts_with_clamp_edges(rng, batch, row_px, rows)
    t = torch.from_numpy(rng.uniform(size=(batch, rows, row_px, 3)).astype(np.float32))
    t = t.to(getattr(torch, dtype))
    plan = shift_plan(batch, rows, row_px, 3, t.element_size(), True)
    assert plan.kernel == "shift_cols_band"
    got = _shift_cols_band_model(_bits(t), shifts, plan)
    got = torch.from_numpy(got).view(t.dtype).transpose(1, 2).float().numpy()
    view = jnp.asarray(t.float().numpy()).astype(dtype).swapaxes(1, 2)
    want = pallas_shift.row_shift(view, jnp.asarray(shifts), interpret=True)
    np.testing.assert_array_equal(got, np.asarray(want.astype(jnp.float32)))
    # and the wrapper's CPU path (the plain version) on the same view
    np.testing.assert_array_equal(
        row_shift(t.transpose(1, 2), torch.from_numpy(shifts)).float().numpy(), got)


# -- extract_patches: the plan ----------------------------------------------


def test_patch_plan_at_the_flagship_and_odd_sizes():
    """P = 224, C = 3: a row is 42 chunks, 6 rows a pass (252 threads), 24
    rows a block, 10 blocks a patch; P * C no multiple of 16: the byte
    path."""
    assert patch_plan(5056, 224, 3) == ("gather_rows16", 252, 24, 5056 * 10)
    assert patch_plan(7, 15, 3) == ("gather_bytes", 128, 8, 7 * 2)
    assert patch_plan(7, 15, 4) == ("gather_bytes", 128, 8, 7 * 2)
    assert patch_plan(7, 16, 1) == ("gather_rows16", 256, 16, 7)
    assert patch_plan(2, 1024, 4) == ("gather_rows16", 256, 4, 2 * 256)


@pytest.mark.parametrize("p,c", [(224, 3), (16, 1), (16, 3), (32, 4), (48, 1), (15, 3),
                                 (1024, 4), (64, 8)])
def test_patch_plan_covers_every_row_and_chunk_once(p, c):
    plan = patch_plan(3, p, c)
    per_patch = plan.ctas // 3
    rows = [py for by in range(per_patch)
            for py in range(by * plan.rows_per_cta, min((by + 1) * plan.rows_per_cta, p))]
    assert rows == list(range(p))
    assert plan.threads <= 256
    if plan.kernel == "gather_rows16":
        chunks = p * c // 16
        lanes = min(chunks, plan.threads)
        assert chunks * 16 == p * c and plan.threads % lanes == 0
        owned = sorted(j for jt in range(lanes) for j in range(jt, chunks, lanes))
        assert owned == list(range(chunks))


# -- extract_patches: the gather kernels' model ------------------------------


class _Memory:
    """The slide's bytes at a virtual address whose residue mod 16 is
    ``misalign``; every 16-byte word read must hold a byte of the slide."""

    def __init__(self, slide: np.ndarray, misalign: int):
        self.addr = 4096 + misalign
        self.size = slide.size
        self.bytes = np.zeros(misalign + slide.size + 32, np.uint8)
        self.bytes[misalign:misalign + slide.size] = slide.reshape(-1)
        self.words = 0

    def word(self, a: int):
        assert a % 16 == 0 and a < self.addr + self.size and a + 16 > self.addr
        self.words += 1
        return [int(x) for x in self.bytes[a - 4096:a - 4096 + 16].view("<u4")]


def _low_bytes(n: int) -> int:
    return (1 << (8 * n)) - 1


def _load_realigned(mem: _Memory, a: int, vlo: int, vhi: int) -> bytes:
    """The kernel's load_realigned: aligned words, word selects, funnel
    shift, edge masks."""
    base = a & ~15
    o = a - base
    lo = mem.word(base) if o + vlo < 16 else [0] * 4
    hi = mem.word(base + 16) if o + vhi > 16 else [0] * 4
    win = lo + hi
    ws, bits = o >> 2, (o & 3) * 8
    u = [win[t + ws] for t in range(5)]
    v = [((u[m] | u[m + 1] << 32) >> bits) & 0xFFFFFFFF for m in range(4)]
    if vlo > 0 or vhi < 16:
        for m in range(4):
            lo_m, hi_m = min(max(vlo - 4 * m, 0), 4), min(max(vhi - 4 * m, 0), 4)
            v[m] &= _low_bytes(hi_m) & ~_low_bytes(lo_m)
    return np.array(v, "<u4").tobytes()


def _shift_rows16_model(image: np.ndarray, shifts: np.ndarray, misalign: int):
    """shift_rows16 on the bytes of a contiguous (B, H, W, C) image (at an
    address residue ``misalign`` of the model's memory; the kernel takes
    aligned buffers, the model shows the arithmetic does not depend on it):
    one block per memory row, thread t owns chunks t, t + threads, ...
    Returns the output bytes."""
    b, h, w, c = image.shape
    px_bytes = c * image.itemsize
    plan = shift_plan(b, h, w, c, image.itemsize, False)
    assert plan.kernel == "shift_rows16" and plan.blocks == b * h
    raw = image.reshape(b * h, w * c).view(np.uint8)
    mem = _Memory(raw, misalign)
    n = w * px_bytes
    out = np.zeros_like(raw)
    writes = np.zeros(raw.shape, np.int64)
    half = w // 2
    for row in range(plan.blocks):
        off = int(np.clip(shifts.reshape(-1)[row], -half, half)) * px_bytes
        src = mem.addr + row * n
        for t in range(plan.threads):
            for j in range(t, n // 16, plan.threads):
                vlo, vhi = max(off - 16 * j, 0), min(n + off - 16 * j, 16)
                if vlo < vhi:
                    chunk = _load_realigned(mem, src + 16 * j - off, vlo, vhi)
                    out[row, 16 * j:16 * (j + 1)] = np.frombuffer(chunk, np.uint8)
                writes[row, 16 * j:16 * (j + 1)] += 1
    assert (writes == 1).all()
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["paeth", "random"])
def test_rows16_kernel_model_matches_jax_row_shift(rng, dtype, case):
    """The model of shift_rows16 on (B, 16, W, 3) images equals JAX's
    row_shift, at the Paeth row shears of drawn angles (W = 16) and at
    random shifts with the clamp edges (W = 40), the image at address
    residues 0 and 8."""
    batch, w = (6, 16) if case == "paeth" else (3, 40)
    if case == "paeth":
        angles = torch.from_numpy(rng.uniform(-180, 180, size=batch).astype(np.float32))
        shifts = augment.paeth_shears(angles, 16)[1].numpy()
    else:
        shifts = _shifts_with_clamp_edges(rng, batch, 16, w)
    x = torch.from_numpy(rng.uniform(size=(batch, 16, w, 3)).astype(np.float32))
    x = x.to(getattr(torch, dtype))
    want = pallas_shift.row_shift(jnp.asarray(x.float().numpy()).astype(dtype),
                                  jnp.asarray(shifts), interpret=True)
    for misalign in (0, 8):
        got = _shift_rows16_model(_bits(x), shifts, misalign)
        got = torch.from_numpy(got.view(_bits(x).dtype).reshape(x.shape)).view(x.dtype)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))


def _gather_model(slide: np.ndarray, centers: np.ndarray, p: int, misalign: int):
    """gather_rows16 or gather_bytes, as patch_plan picks, block by block
    and thread by thread; returns (patches, 16-byte words read)."""
    h, w, c = slide.shape
    n = len(centers)
    plan = patch_plan(n, p, c)
    mem = _Memory(slide, misalign)
    row_bytes = p * c
    out = np.zeros((n, p, row_bytes), np.uint8)
    writes = np.zeros(out.shape, np.int64)
    r = p // 2
    per_patch = plan.ctas // n
    for i, (x, y) in enumerate(centers.astype(np.int64).tolist()):
        x0, y0 = x - r, y - r
        px_lo = -x0 if x0 < 0 else 0
        px_hi = min(2 * r, w - x0)
        blo = px_lo * c
        bhi = px_hi * c if px_hi > px_lo else blo
        for by in range(per_patch):
            py0 = by * plan.rows_per_cta
            py_end = min(py0 + plan.rows_per_cta, p)
            if plan.kernel == "gather_bytes":
                for py in range(py0, py_end):
                    sy = y0 + py
                    if py < 2 * r and 0 <= sy < h and blo < bhi:
                        src = mem.addr + (sy * w + x0) * c - 4096
                        out[i, py, blo:bhi] = mem.bytes[src + blo:src + bhi]
                    writes[i, py] += 1
                continue
            chunks = row_bytes // 16
            lanes = min(chunks, plan.threads)
            rstep = plan.threads // lanes
            for t in range(plan.threads):
                for py in range(py0 + t // lanes, py_end, rstep):
                    sy = y0 + py
                    in_slide = py < 2 * r and 0 <= sy < h
                    src = mem.addr + (sy * w + x0) * c
                    for j in range(t % lanes, chunks, lanes):
                        vlo, vhi = max(blo - 16 * j, 0), min(bhi - 16 * j, 16)
                        if in_slide and vlo < vhi:
                            chunk = _load_realigned(mem, src + 16 * j, vlo, vhi)
                            out[i, py, 16 * j:16 * (j + 1)] = np.frombuffer(chunk, np.uint8)
                        writes[i, py, 16 * j:16 * (j + 1)] += 1
    assert (writes == 1).all()
    return out.reshape(n, p, p, c), mem.words


def _residue_centers(w: int, h: int, p: int) -> np.ndarray:
    """Crop starts x0 = x - P//2 from -20 to w + 3 (every residue mod 16,
    inside and across both side edges), on rows inside, across the top and
    bottom edges and far outside; a missing spot's -2147483648 and the
    largest int32."""
    r = p // 2
    xs = np.arange(r - 20, r + w + 4)
    ys = np.array([r, h // 2, h - 1, -r + 3, h + r - 3, -5 * h])
    extra = [[I32_MIN, I32_MIN], [I32_MIN, h // 2], [h // 2, I32_MIN], [I32_MAX, I32_MAX]]
    return np.concatenate([np.stack([xs, ys[xs % len(ys)]], 1), extra]).astype(np.int64)


@pytest.mark.parametrize("c", [1, 3, 4])
@pytest.mark.parametrize("p", [16, 32, 15])
def test_gather_kernel_model_matches_jax_numpy(rng, c, p):
    """On a 50 x 83 slide (W * C = 83, 249, 332 bytes: no multiple of 16)
    at every address residue of the slide mod 16, crops at every start
    residue: the model equals JAX ``extract_patches_np`` bit for bit.
    gather_rows16 at P * C = 16, 48, 64, 32, 96, 128; the byte path at P =
    15."""
    slide = rng.integers(0, 256, size=(50, 83, c), dtype=np.uint8)
    centers = _residue_centers(83, 50, p)
    want = jax_extract_patches_np(slide, centers, p)
    assert want.any() and not want[-4:].any()
    for misalign in (0, 5, 11) if p == 16 else (7,):
        got, words = _gather_model(slide, centers, p, misalign)
        np.testing.assert_array_equal(got, want, err_msg=f"misalign {misalign}")
        # every in-slide output byte comes through at most two words a chunk
        assert (words > 0) == (patch_plan(1, p, c).kernel == "gather_rows16")


def test_gather_kernel_model_at_the_flagship_patch(rng):
    """P = 224, C = 3 (42 chunks a row, 6 rows a pass) on a 300 x 301
    slide: a center inside, one across each edge, the missing spot's."""
    slide = rng.integers(0, 256, size=(300, 301, 3), dtype=np.uint8)
    centers = np.array([[150, 150], [5, 150], [150, 3], [297, 290], [301 + 100, 200],
                        [I32_MIN, I32_MIN]], np.int64)
    got, _ = _gather_model(slide, centers, 224, 9)
    np.testing.assert_array_equal(got, jax_extract_patches_np(slide, centers, 224))
