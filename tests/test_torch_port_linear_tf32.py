"""The 3xTF32 warpgroup GEMM of the fp32 linear maps and the plan that picks it.

Large fp32 linear maps (``DenseT``, the GraphSAGE linear) run on
``csrc/linear_tf32.cu`` where ``ops.linear.linear_plan`` picks it: a split
pass writes each operand's tf32 big and small parts in the K-major layout its
product reads (as stored, or transposed for the backward), then a persistent
``wgmma`` kernel sums small * big + big * small + big * big in fp32. On the
CPU:

  (a) ``linear_plan`` at every shape the benchmark's five cells launch, its
      crossover and its limits, ``split_plan``'s slices of the depth, and
      the scratch ``forward_plan`` and ``backward_plan`` give the C calls;
  (b) routing: ``DenseT`` and ``GraphSAGEBlock`` on stand-in entry points
      that compute what the C entry points compute from what they are given
      (the split copies and the products, in numpy, from the pointers) and
      record each copy and product:
      their outputs and gradients against ``F.linear``'s, ``wg_launches``
      in a HisToGene step (34 forward, 67 backward products), in a baked
      Hist2ST pass (all but the 1-wide coef output) and in the flagship's
      train step (none);
  (c) the bf16, CPU, DTensor and other tensor-subclass paths keep
      ``F.linear``; a strided bias view is read as its values;
  (d) the split copies' layouts, transposed and ragged (785) included;
  (e) a numpy model of the tiled 3xTF32 product against float64: fp32-level
      error, and TF32's at least 10 times larger.

On the card (``gpu`` marker): forward, dX, dW and db against float64 at the
slide models' shapes and a ragged one, each within twice cuBLAS fp32's own
error; the same bits on two runs; autograd through ``DenseT``:

    python -m pytest --noconftest tests/test_torch_port_linear_tf32.py -m gpu
"""

import contextlib
import ctypes
import os
import tempfile
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mclstexp_tpu_torch.baselines.layers import GraphSAGEBlock
from mclstexp_tpu_torch.baselines.models import Hist2ST, HisToGene
from mclstexp_tpu_torch.config import ModelConfig
from mclstexp_tpu_torch.core.layers import DenseT, set_compute_dtype
from mclstexp_tpu_torch.core.losses import symmetric_infonce
from mclstexp_tpu_torch.models.mclstexp import MclSTExp
from mclstexp_tpu_torch.ops import linear as lin

torch.set_num_threads(1)


# --- (a) the plan -----------------------------------------------------------------------------

# (m, n, k) of every fp32 linear map the cells' steps launch, forward shapes:
# HisToGene (dim 1,024, 8 layers, mlp 2,048, 785 genes, 112-px patches) and
# Hist2ST (dim 1,024, mlp 1,024, GraphSAGE 1,024, ZINB heads, the coef head)
# on 4,096-row slides; HisToGene on the her2st buckets; mclSTExp's spot tower
# and heads (spot_dim 785, 8 x 64 heads, projection 256, 1,024 image
# features) at batch 128 and the partial 83, and the service's buckets.
VISIUM_HISTOGENE = [(4096, 1024, 37632), (4096, 3072, 1024), (4096, 1024, 1024),
                    (4096, 2048, 1024), (4096, 1024, 2048), (4096, 785, 1024)]
VISIUM_HIST2ST = [(4096, 3072, 1024), (4096, 1024, 1024), (4096, 785, 1024)]
HER2ST_SLIDES = [(m, n, k) for m in (384, 512, 640, 768) for _, n, k in VISIUM_HISTOGENE]
FLAGSHIP = [(m, n, k) for m in (128, 83, 1, 37, 256) for n, k in
            ((1536, 785), (785, 512), (785, 785), (256, 1024), (256, 785), (256, 256))]


@pytest.mark.parametrize("shape", VISIUM_HISTOGENE + VISIUM_HIST2ST, ids=str)
def test_plan_takes_the_whole_slide_maps(shape):
    assert lin.linear_plan(*shape) == "warpgroup"


@pytest.mark.parametrize("shape", [(4096, 1, 1024), (1024, 3072, 1024), (1536, 1024, 2048)]
                         + HER2ST_SLIDES + FLAGSHIP, ids=str)
def test_plan_leaves_small_shapes_on_cublas(shape):
    """The coef head's 1-wide output, layers under 2,048 rows (where a layer
    alone runs ~50% longer on the kernel, host included), HisToGene's
    her2st slides and every mclSTExp shape stay on cuBLAS."""
    assert lin.linear_plan(*shape) == "cublas"


@pytest.mark.parametrize("shape,want", [
    ((lin.WG_MIN_ROWS - 1, 1024, 1024), "cublas"), ((lin.WG_MIN_ROWS, 1024, 1024), "warpgroup"),
    ((4096, lin.WG_MIN_WIDTH - 1, 1024), "cublas"), ((4096, lin.WG_MIN_WIDTH, 1024), "warpgroup"),
    ((4096, 1024, lin.WG_MIN_WIDTH - 1), "cublas"), ((4096, 1024, lin.WG_MIN_WIDTH), "warpgroup"),
    ((2**31, 1024, 1024), "cublas"), ((4096, 2**31, 1024), "cublas"),
])
def test_plan_crossover(shape, want):
    assert lin.linear_plan(*shape) == want


@pytest.mark.parametrize("shape", [(0, 8, 8), (8, 0, 8), (8, 8, 0), (-1, 8, 8)])
def test_plan_refuses_empty_shapes(shape):
    with pytest.raises(ValueError):
        lin.linear_plan(*shape)


@pytest.mark.parametrize("rows,cols,depth,want", [
    (4096, 3072, 1024, 1), (4096, 1024, 37632, 1), (4096, 1024, 1024, 1),  # forward, dX
    (1024, 1024, 4096, 2), (3072, 1024, 4096, 2), (785, 1024, 4096, 7),  # dW: few tiles
    (2048, 1024, 4096, 1), (1024, 37632, 4096, 1),
    (128, 128, 4096, 8), (128, 128, 96, 1), (128, 128, 256, 2),  # slices of >= 4 k-blocks
])
def test_split_plan(rows, cols, depth, want):
    assert lin.split_plan(rows, cols, depth) == want


# --- (b) routing, on stand-in entry points ----------------------------------------------------

def _floats(ptr: int, count: int) -> np.ndarray:
    return np.ctypeslib.as_array((ctypes.c_float * count).from_address(ptr))


def tf32(x):
    """cvt.rna.tf32.f32: fp32 x rounded to 10 mantissa bits, ties away from
    zero, the low 13 bits 0 (finite inputs)."""
    bits = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return ((bits + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)


def split(x):
    x = np.asarray(x, np.float32)
    big = tf32(x)
    return big, tf32(x - big)


def product3(a_parts, b_parts):
    """A B^T in 3xTF32 from split parts, (small * big + big * small) + big *
    big, each product exact (float64), rounded to fp32 once."""
    (ab, as_), (bb, bs) = a_parts, b_parts
    t = lambda u, v: u.astype(np.float64) @ v.astype(np.float64).T  # noqa: E731
    return ((t(as_, bb) + t(ab, bs)) + t(ab, bb)).astype(np.float32)


class Card:
    """Stand-ins for the C entry points: each computes, in numpy, what the
    kernels compute from the pointers and extents they are given (CPU
    tensors standing for CUDA ones), in the scratch layout the entry points
    document, and records each split copy and product."""

    def __init__(self):
        self.copies, self.parts, self.products = [], [], []

    def _split(self, src, ld, rows, cols, trans, dst):
        """The copy of src (rows x cols, row stride ld), or of its transpose,
        at dst: [2][rows padded to 128][depth padded to 32]; its floats."""
        whole = _floats(src, (rows - 1) * ld + cols)
        x = np.lib.stride_tricks.as_strided(whole, (rows, cols), (4 * ld, 4)).copy()
        x = x.T if trans else x
        out_rows, depth = lin._pad(x.shape[0], 128), lin._pad(x.shape[1], 32)
        padded = np.zeros((out_rows, depth), np.float32)
        padded[:x.shape[0], :x.shape[1]] = x
        out = _floats(dst, 2 * out_rows * depth).reshape(2, out_rows, depth)
        out[0], out[1] = split(padded)
        self.copies.append((rows, cols, bool(trans), out_rows, depth))
        self.parts.append(out.copy())
        return out

    def _gemm(self, pa, pb, out, bias, m, n, splits):
        depth = pa.shape[2]
        blocks = depth // 32
        assert 1 <= splits <= blocks and pb.shape[2] == depth
        total = np.zeros((m, n), np.float32)
        for s in range(splits):  # the slices' partial sums, added in order
            k0, k1 = 32 * (s * blocks // splits), 32 * ((s + 1) * blocks // splits)
            total += product3(pa[:, :m, k0:k1], pb[:, :n, k0:k1])
        if bias is not None:
            total += _floats(bias, n)
        _floats(out, m * n).reshape(m, n)[...] = total
        self.products.append((m, n, depth, splits))

    def _launch(self, operands, products, scratch, floats):
        """Each operand's copy back to back from scratch, then the products
        (operand indices, out, bias, m, n, splits); floats must hold the
        copies and the largest product's partial sums."""
        parts, at = [], scratch
        for operand in operands:
            parts.append(self._split(*operand, at))
            at += 4 * parts[-1].size
        partials = max([s * m * n for *_, m, n, s in products if s > 1], default=0)
        assert floats >= (at - scratch) // 4 + partials
        for a, b, out, bias, m, n, s in products:
            self._gemm(parts[a], parts[b], out, bias, m, n, s)
        return 0

    def forward(self, x, ldx, w, ldw, bias, y, scratch, floats, m, n, k, splits, stream):
        return self._launch([(x, ldx, m, k, False), (w, ldw, n, k, False)],
                            [(0, 1, y, bias, m, n, splits)], scratch, floats)

    def backward(self, x, ldx, w, ldw, dy, lddy, dx, dw, scratch, floats, m, n, k, splits_dx,
                 splits_dw, stream):
        operands, products = [], []
        if splits_dx:
            operands += [(dy, lddy, m, n, False), (w, ldw, n, k, True)]
            products.append((len(operands) - 2, len(operands) - 1, dx, None, m, k, splits_dx))
        if splits_dw:
            operands += [(dy, lddy, m, n, True), (x, ldx, m, k, True)]
            products.append((len(operands) - 2, len(operands) - 1, dw, None, n, k, splits_dw))
        assert products
        return self._launch(operands, products, scratch, floats)


@contextlib.contextmanager
def card(monkeypatch, everywhere=False):
    """CPU tensors taken for CUDA ones by ``ops.linear``, its entry points the
    stand-ins of ``Card``; with ``everywhere`` the plan takes every shape."""
    stand_in = Card()
    monkeypatch.setattr(lin, "DEVICE", "cpu")
    monkeypatch.setattr(lin, "_entries", lambda: (stand_in.forward, stand_in.backward))
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    if everywhere:
        monkeypatch.setattr(lin, "WG_MIN_ROWS", 1)
        monkeypatch.setattr(lin, "WG_MIN_WIDTH", 1)
    yield stand_in


def _grads(module, x, *args):
    x = x.clone().requires_grad_(True)
    out = module(x, *args)
    cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(7))
    grads = torch.autograd.grad((out * cot).sum(), [x, *module.parameters()])
    return out.detach(), grads


@pytest.mark.parametrize("shape", [(2100, 72, 96), (2060, 785, 64), (2, 1100, 80, 72)], ids=str)
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
def test_dense_on_the_kernel_matches_f_linear(monkeypatch, shape, bias):
    """A ``DenseT`` above the crossover (rows of every leading dimension
    counted) runs forward, dX and dW on the kernel, each after one split
    pass (the backward's four copies in one), and matches ``F.linear``'s
    output and gradients."""
    *lead, n, k = shape
    layer = DenseT(k, n, bias=bias, device="cpu")
    x = torch.randn((*lead, k), generator=torch.Generator().manual_seed(1))
    want, want_grads = _grads(layer, x)
    before = lin.linear_fp32.wg_launches
    with card(monkeypatch) as stand_in:
        got, got_grads = _grads(layer, x)
    rows = int(np.prod(lead))
    assert lin.linear_fp32.wg_launches == before + 3
    assert [p[:3] for p in stand_in.products] == [(rows, n, lin._pad(k, 32)),
                                                  (rows, k, lin._pad(n, 32)),
                                                  (n, k, lin._pad(rows, 32))]
    assert [c[2] for c in stand_in.copies] == [False, False, False, True, True, True]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    for g, w in zip(got_grads, want_grads):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-4)


def test_graph_sage_on_the_kernel(monkeypatch):
    """``GraphSAGEBlock``'s linear (no bias) on the kernel; the dense
    neighbour mean ``adj @ x`` stays a plain product."""
    g = torch.Generator().manual_seed(2)
    block = GraphSAGEBlock(64, 96, device="cpu")
    torch.nn.init.xavier_uniform_(block.weight, generator=g)
    x = torch.randn((2048, 64), generator=g)
    adj = (torch.rand((2048, 2048), generator=g) < 0.002).float()
    want, want_grads = _grads(block, x, adj)
    with card(monkeypatch) as stand_in:
        got, got_grads = _grads(block, x, adj)
    assert [p[:2] for p in stand_in.products] == [(2048, 96), (2048, 64), (96, 64)]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    for a, b in zip(got_grads, want_grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_histogene_step_counts(monkeypatch):
    """One HisToGene slide step at its depth (8 layers, each qkv, out and the
    MLP's two maps, then the patch embedding and the gene head): 34 products
    forward, 67 backward (the patch embedding's input takes no gradient),
    every map on the kernel; the gradients those of ``F.linear``."""
    model = HisToGene(n_genes=7, patch_size=2, dim=32, n_layers=8, heads=2, n_pos=16,
                      device="cpu").eval()
    g = torch.Generator().manual_seed(3)
    patches = torch.rand((40, 2, 2, 3), generator=g)
    positions = torch.randint(0, 16, (40, 2), generator=g)

    def step():
        pred = model(patches, positions)
        return [pred.detach(), *torch.autograd.grad(pred.square().sum(), model.parameters())]

    want = step()
    with card(monkeypatch, everywhere=True) as stand_in:
        before = lin.linear_fp32.wg_launches
        pred = model(patches, positions)
        forward = lin.linear_fp32.wg_launches - before
        grads = torch.autograd.grad(pred.square().sum(), model.parameters())
        backward = lin.linear_fp32.wg_launches - before - forward
    assert (forward, backward) == (34, 67)
    assert len(stand_in.products) == 101
    for a, b in zip([pred.detach(), *grads], want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_hist2st_pass_counts(monkeypatch):
    """One Hist2ST pass with the coef head (a baked pass; 8 attention layers,
    4 GraphSAGE blocks): every linear map on the kernel but the coef head's
    1-wide output, under the plan's width: 41 products forward (8 x 4, 4, the
    gene head, 3 ZINB heads, the coef head's first map), 82 backward; the
    outputs and gradients those of ``F.linear``. A step's six passes (one
    plain, five baked) launch 245 forward and 460 backward: the baked passes'
    ZINB heads feed no loss, so their 15 products take no gradient."""
    g = torch.Generator().manual_seed(8)
    model = Hist2ST(n_genes=5, fig_size=14, patch_size=7, channel=16, depth1=1, heads=2,
                    n_pos=16, coef_head=True, device="cpu").eval()
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.2)
    n = 24
    patches = torch.rand((n, 14, 14, 3), generator=g)
    positions = torch.randint(0, 16, (n, 2), generator=g)
    adj = (torch.rand((n, n), generator=g) < 0.2).float()

    def loss():
        pred, extra, coef = model(patches, positions, adj, aug=True)
        return pred.square().sum() + sum(e.sum() for e in extra) + coef.sum()

    def grads():
        value = loss()
        return [value.detach(), *torch.autograd.grad(value, model.parameters())]

    want = grads()
    with card(monkeypatch, everywhere=True):
        monkeypatch.setattr(lin, "WG_MIN_WIDTH", 2)
        before = lin.linear_fp32.wg_launches
        value = loss()
        forward = lin.linear_fp32.wg_launches - before
        got = [value.detach(), *torch.autograd.grad(value, model.parameters())]
        backward = lin.linear_fp32.wg_launches - before - forward
    assert (forward, backward) == (41, 82)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


TINY = dict(encoder_name="tiny_densenet", image_dim=16, spot_dim=24, projection_dim=32,
            heads_num=2, heads_dim=16, pos_vocab=64, dense_block_impl="concat")


def test_flagship_train_step_stays_on_cublas(monkeypatch):
    """The flagship's forward and backward at her2st's batch of 128 launch no
    product on the kernel: its linear maps are under the crossover."""
    model = MclSTExp(ModelConfig(**TINY), device="cpu")
    g = torch.Generator().manual_seed(4)
    batch = {"image": torch.rand((128, 16, 16, 3), generator=g),
             "expression": torch.rand((128, 24), generator=g),
             "position": torch.randint(0, 64, (128, 2), generator=g)}
    with card(monkeypatch) as stand_in:
        before = lin.linear_fp32.wg_launches
        image_emb, spot_emb = model(batch)
        symmetric_infonce(spot_emb, image_emb, 1.0).backward()
    assert lin.linear_fp32.wg_launches == before and stand_in.products == []


# --- (c) the paths that keep F.linear ---------------------------------------------------------

def _recorded(monkeypatch, module, x):
    with card(monkeypatch, everywhere=True) as stand_in:
        module(x)
    return stand_in.products


def test_bf16_keeps_f_linear(monkeypatch):
    layer = set_compute_dtype(DenseT(64, 64, device="cpu"), torch.bfloat16)
    assert _recorded(monkeypatch, layer, torch.randn(2048, 64)) == []


def test_cpu_tensors_keep_f_linear():
    """Off a card ``linear`` is ``F.linear`` itself, bit for bit, and
    ``linear_fp32`` its plain version."""
    g = torch.Generator().manual_seed(5)
    x, w, b = torch.randn(2048, 64, generator=g), torch.randn(96, 64, generator=g), torch.randn(
        96, generator=g)
    before = lin.linear_fp32.wg_launches
    assert not lin.kernel_route(x, w)
    assert torch.equal(lin.linear(x, w, b), F.linear(x, w, b))
    assert torch.equal(lin.linear_fp32(x, w, b), F.linear(x, w, b))
    assert lin.linear_fp32.wg_launches == before


def test_dtensor_weights_keep_f_linear(monkeypatch):
    """``parallel/tp.py``'s DTensor weights (here on a one-rank gloo mesh)
    stay on ``F.linear`` even where the plan would take the shape."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, distribute_tensor

    made = not dist.is_initialized()
    if made:
        store = os.path.join(tempfile.mkdtemp(), "store")
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (dist.get_world_size(),))
        w = distribute_tensor(torch.randn(96, 64), mesh, [Replicate()])
        x = distribute_tensor(torch.randn(2048, 64), mesh, [Replicate()])
        with card(monkeypatch, everywhere=True) as stand_in:
            assert not lin.kernel_route(x, w)
            assert not lin.kernel_route(x.to_local(), w)
            assert lin.kernel_route(x.to_local(), w.to_local())
            lin.linear(x, w)
        assert stand_in.products == []
    finally:
        if made:
            dist.destroy_process_group()


def test_linear_fp32_refuses_what_the_kernel_does_not_take(monkeypatch):
    with card(monkeypatch):
        for x, w, b in [(torch.randn(4, 8), torch.randn(3, 9), None),
                        (torch.randn(4, 8, dtype=torch.float64), torch.randn(3, 8), None),
                        (torch.randn(4, 8), torch.randn(3, 8), torch.randn(4)),
                        (torch.randn(0, 8), torch.randn(3, 8), None)]:
            with pytest.raises((ValueError, TypeError)):
                lin.linear_fp32(x, w, b)


def test_strided_bias_is_read_as_its_values(monkeypatch):
    """A bias that is a strided view (every other value of a longer tensor)
    reaches the kernel as its n values: the output and the bias's gradient
    those of ``F.linear``."""
    g = torch.Generator().manual_seed(9)
    x, w = torch.randn((2050, 64), generator=g), torch.randn((96, 64), generator=g)
    b = torch.randn((192,), generator=g)[::2].requires_grad_(True)
    assert b.stride(0) == 2
    want = F.linear(x, w, b)
    (want_db,) = torch.autograd.grad(want.sum(), b)
    with card(monkeypatch) as stand_in:
        got = lin.linear(x, w, b)
        (got_db,) = torch.autograd.grad(got.sum(), b)
    assert len(stand_in.products) == 1
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got_db, want_db)


class _Sub(torch.Tensor):
    pass


def test_tensor_subclasses_keep_f_linear(monkeypatch):
    """Only plain tensors and parameters take the kernel: any subclass (a
    DTensor, a wrapper of another library) stays with ``F.linear``."""
    x, w = torch.randn(2048, 64), torch.nn.Parameter(torch.randn(96, 64))
    with card(monkeypatch, everywhere=True) as stand_in:
        assert lin.kernel_route(x, w)
        assert not lin.kernel_route(x.as_subclass(_Sub), w)
        assert not lin.kernel_route(x, w.detach().as_subclass(_Sub))
        lin.linear(x.as_subclass(_Sub), w)
    assert stand_in.products == []


@pytest.mark.parametrize("shape,want", [
    # x (4096 x 1024) and w (785 x 1024, rows padded to 896): one slice
    ((4096, 785, 1024, None, None), (2 * (4096 + 896) * 1024, 1)),
    # dX: dY (4096 x 800) and w^T (1024 x 800); dW: dY^T (896 x 4096) and x^T
    # (1024 x 4096) over 7 slices of 785 x 1024 partial sums
    ((4096, 785, 1024, True, True),
     (2 * (4096 + 1024) * 800 + 2 * (896 + 1024) * 4096 + 7 * 785 * 1024, 1, 7)),
    ((4096, 785, 1024, False, True), (2 * (896 + 1024) * 4096 + 7 * 785 * 1024, 0, 7)),
    ((4096, 3072, 1024, True, False), (2 * (4096 + 1024) * 3072, 1, 0)),
], ids=str)
def test_scratch_plans(shape, want):
    """The scratch the entry points take, in floats, and the slices of each
    product: the split copies back to back, then the partial sums."""
    m, n, k, need_x, need_w = shape
    got = (lin.forward_plan(m, n, k) if need_x is None
           else lin.backward_plan(m, n, k, need_x, need_w))
    assert got == want


# --- (d) the split copies ---------------------------------------------------------------------

@pytest.mark.parametrize("rows,cols,trans", [(300, 785, False), (300, 785, True),
                                              (128, 32, False), (1, 1, True)])
def test_split_copies_layout(monkeypatch, rows, cols, trans):
    """A copy is [2][rows][depth]: the source (or its transpose) in the first
    rows and columns, zero past them, part 0 the tf32 big parts and part 1
    the small ones; a strided source (a view with rows 800 floats apart) is
    read through its row stride. As stored: x in the forward; transposed:
    x^T in the backward's weight gradient, after dY^T."""
    g = torch.Generator().manual_seed(6)
    src = torch.randn((rows, 800), generator=g)[:, :cols]
    want = src.T if trans else src
    with card(monkeypatch) as stand_in:
        if trans:
            lin._backward(src, torch.randn((8, cols), generator=g),
                          torch.randn((rows, 8), generator=g), False, True)
        else:
            lin._forward(src, torch.randn((8, cols), generator=g), None)
    copy = stand_in.parts[1 if trans else 0]
    assert copy.shape == (2, lin._pad(want.shape[0], lin.ROW_PAD), lin._pad(want.shape[1], 32))
    assert stand_in.copies[1 if trans else 0][:3] == (rows, cols, trans)
    big, small = split(want.numpy())
    np.testing.assert_array_equal(copy[0, :want.shape[0], :want.shape[1]], big)
    np.testing.assert_array_equal(copy[1, :want.shape[0], :want.shape[1]], small)
    copy[:, :want.shape[0], :want.shape[1]] = 0
    assert not copy.any()


def test_split_copy_shapes_of_the_step():
    """The copies a 785-wide head's forward and backward ask for at 4,096
    rows: rows padded to 128, depth to 32 (785 -> 896 and 800)."""
    m, n, k = 4096, 785, 1024
    assert (lin._pad(n, lin.ROW_PAD), lin._pad(n, lin.DEPTH_PAD)) == (896, 800)
    assert lin._pad(m, lin.ROW_PAD) == lin._pad(m, lin.DEPTH_PAD) == m
    assert lin._pad(k, lin.ROW_PAD) == k


# --- (e) the tiled product --------------------------------------------------------------------

def tiled_product(a, b, bk=32):
    """The kernel's sum on (m, k) a and (n, k) b: per 32-deep stage the
    three products of the split parts (exact, float64), rounded to fp32 and
    added to the running fp32 sum."""
    total = np.zeros((a.shape[0], b.shape[0]), np.float32)
    for k0 in range(0, a.shape[1], bk):
        total += product3(split(a[:, k0:k0 + bk]), split(b[:, k0:k0 + bk]))
    return total


@pytest.mark.parametrize("k", [64, 1024])
def test_tiled_3xtf32_keeps_fp32_accuracy(k):
    """Against float64 the tiled 3xTF32 product errs at fp32's level (within
    4x of a float32 matmul's error), and one TF32 product at least 10x
    more."""
    rng = np.random.default_rng(k)
    a = rng.standard_normal((48, k)).astype(np.float32)
    b = rng.standard_normal((40, k)).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64).T

    def err(x):
        return np.linalg.norm(x - exact) / np.linalg.norm(exact)

    three = err(tiled_product(a, b))
    fp32 = err((torch.from_numpy(a) @ torch.from_numpy(b).T).numpy())
    one = err(tf32(a).astype(np.float64) @ tf32(b).astype(np.float64).T)
    assert three < 4 * max(fp32, 2.0**-24)
    assert one > 10 * three


# --- on the card ------------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(23)


def _rel(x, exact):
    return (torch.linalg.norm((x.double() - exact).flatten())
            / torch.linalg.norm(exact.flatten())).item()


CARD_SHAPES = [(4096, 1024, 37632), (4096, 3072, 1024), (4096, 1024, 2048), (4096, 785, 1024),
               (3969, 1024, 1024)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=str)
def test_kernel_against_float64(cuda, shape):
    """Forward, dX, dW and db of ``linear_fp32`` against float64, each within
    twice cuBLAS fp32's error on the same inputs; the same bits on a second
    run; three products counted."""
    m, n, k = shape
    x = torch.randn((m, k), generator=cuda, device="cuda")
    w = (torch.rand((n, k), generator=cuda, device="cuda") * 2 - 1) * k**-0.5
    b = torch.randn((n,), generator=cuda, device="cuda")
    dy = torch.randn((m, n), generator=cuda, device="cuda")

    def grads(fn, *args):
        args = [t.detach().requires_grad_(True) for t in args]
        y = fn(*args)
        return (y.detach(), *torch.autograd.grad(y, args, dy.to(y.dtype)))

    before = lin.linear_fp32.wg_launches
    got = grads(lin.linear_fp32, x, w, b)
    assert lin.linear_fp32.wg_launches == before + 3
    again = grads(lin.linear_fp32, x, w, b)
    assert all(torch.equal(u, v) for u, v in zip(got, again))
    library = grads(F.linear, x, w, b)
    exact = grads(F.linear, x.double(), w.double(), b.double())
    for name, g, lib_, ex in zip(("y", "dx", "dw", "db"), got, library, exact):
        assert _rel(g, ex) <= 2 * _rel(lib_, ex), (name, _rel(g, ex), _rel(lib_, ex))


@pytest.mark.gpu
def test_dense_autograd_on_the_card(cuda):
    """``DenseT`` at HisToGene's qkv shape routes to the kernel (three
    products) and its gradients match float64 autograd at fp32 accuracy."""
    layer = DenseT(1024, 3072, device="cuda")
    x = torch.randn((1, 4096, 1024), generator=cuda, device="cuda", requires_grad=True)
    cot = torch.randn((1, 4096, 3072), generator=cuda, device="cuda")
    before = lin.linear_fp32.wg_launches
    got = torch.autograd.grad((layer(x) * cot).sum(), [x, layer.weight, layer.bias])
    assert lin.linear_fp32.wg_launches == before + 3
    ref = layer.double()
    want = torch.autograd.grad((ref(x.double()) * cot.double()).sum(),
                               [x, ref.weight, ref.bias])
    for g, w in zip(got, want):
        assert _rel(g, w) < 1e-6


# HisToGene's products at 4,096 rows: patch embedding, qkv, out, MLP up and down, gene head
HISTOGENE_SHAPES = [(4096, 1024, 37632), (4096, 3072, 1024), (4096, 1024, 1024),
                    (4096, 2048, 1024), (4096, 1024, 2048), (4096, 785, 1024)]


@pytest.mark.gpu
def test_kernel_at_histogene_whole_slide_products(cuda):
    """Each of HisToGene's whole-slide products, drawn in turn from seed 0:
    on the kernel by ``linear_plan``, three products counted a forward and
    backward, the same bits on a second run; the forward, dX and dW (each
    with its split pass) against float64 within twice cuBLAS fp32's error,
    and cuBLAS with TF32 allowed farther off than that."""
    g = torch.Generator(device="cuda").manual_seed(0)
    for m, n, k in HISTOGENE_SHAPES:
        assert lin.linear_plan(m, n, k) == "warpgroup", (m, n, k)
        x = torch.randn((m, k), generator=g, device="cuda", requires_grad=True)
        w = torch.randn((n, k), generator=g, device="cuda", requires_grad=True)
        b = torch.randn((n,), generator=g, device="cuda", requires_grad=True)
        dy = torch.randn((m, n), generator=g, device="cuda")

        def run():
            y = lin.linear_fp32(x, w, b)
            return (y.detach(), *torch.autograd.grad(y, (x, w, b), dy))

        before = lin.linear_fp32.wg_launches
        first = run()
        assert lin.linear_fp32.wg_launches == before + 3
        assert all(torch.equal(u, v) for u, v in zip(first, run())), (m, n, k)
        del x, w, b, dy, first

        x = torch.randn((m, k), generator=g, device="cuda")
        w = (torch.rand((n, k), generator=g, device="cuda") * 2 - 1) * k**-0.5
        b = torch.randn((n,), generator=g, device="cuda")
        dy = torch.randn((m, n), generator=g, device="cuda")
        exact = (F.linear(x.double(), w.double(), b.double()), dy.double() @ w.double(),
                 dy.double().T @ x.double())
        kernel = (lin._forward(x, w, b), lin._backward(x, w, dy, True, False)[0],
                  lin._backward(x, w, dy, False, True)[1])
        library = (F.linear(x, w, b), dy @ w, dy.T @ x)
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32 = (F.linear(x, w, b), dy @ w, dy.T @ x)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        for name, got, lib_, t32, ex in zip(("y", "dx", "dw"), kernel, library, tf32, exact):
            err, lib_err, tf32_err = _rel(got, ex), _rel(lib_, ex), _rel(t32, ex)
            assert err <= 2 * lib_err < tf32_err, ((m, n, k), name, err, lib_err, tf32_err)
        del x, w, b, dy, exact, kernel, library, tf32
    torch.cuda.empty_cache()
