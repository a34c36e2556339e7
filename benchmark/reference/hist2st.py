"""Plain PyTorch reference of Hist2ST (Zeng et al., Brief. Bioinform.
23(5):bbac297, 2022; upstream ``HIST2ST.py``, ``gcn.py``, ``NB_module.py``,
``graph_construction.py`` and the defaults of ``HIST2ST_train.py``).

One pass: the k x k stride-k convolution of the spot's image into
``channel`` maps, dropout on them, ``depth1`` ConvMixer blocks (two
depthwise convolutions, each with batch norm and exact GELU, the residual,
a 1 x 1 convolution, GELU, batch norm), the 1 x 1 ``down`` convolution to
channel / 8 maps flattened in (c, h, w) order, the x / y position tables,
``depth2`` pre-LN transformer layers over the slide as one sequence (16
heads of 64, an MLP as wide as the model, dropout after the attention's
output projection and twice in the MLP), ``depth3`` GraphSAGE blocks over
the k-NN spot graph (the neighbours' mean, a linear map without bias, ReLU,
each row over its L2 norm), the jump-knowledge 2-layer LSTM that reads the
graph blocks' outputs as its time axis, averaged over it, then the LayerNorm
/ Linear gene head, the ZINB heads (mean, disp, pi) and, on a baked pass,
the ``coef`` head. The loss: the MSE, plus ``zinb`` x the ZINB negative
log-likelihood of the counts with their size factors, plus ``lamb`` x the
MSE between the prediction and the coef-softmax-weighted sum of ``bake``
baked passes, gradients through every pass. Torch Adam, lr constant over
the checked steps (StepLR's first step is at epoch 50).

It runs on the slide's real spots only. The draws are the program's
(``baselines/trainer.py``): a bake's grey, angle and flip from
``torch.rand((bake, 3))`` on a CPU generator seeded from (the step
generator's initial seed, 0); bake i's dropout from a generator on the
step's device seeded from (that seed, i + 1); every dropout mask drawn in
the forward's order at the padded slide's shape and cut to the real rows,
keep where U[0, 1) >= p, kept values scaled by 1 / (1 - p). A bake is the
grey image (luma) if drawn, then the nearest-neighbour rotation about the
image's centre (round half to even, zero fill), then the horizontal flip
if drawn. The spot graph is this file's own k-NN over the array
coordinates, ties broken by ``np.argsort``'s default sort as upstream
``calcADJ`` breaks them, pruned to distance 2 ("grid").

Departures from upstream, each as the program and the JAX package have it:
the LSTM's hidden-side bias ``bias_hh`` is fixed (flax's cell has one
bias; upstream trains both), so no gradient or change is reported for it;
the batch norms take their statistics over the real spots (upstream trains
one unpadded slide a step: the same numbers).

To fit beside nothing else on the card at 3,969 spots (six passes of 8
layers, each with a 16 x n x n score tensor), the image trunk, each
transformer layer and the LSTM run under ``torch.utils.checkpoint``; their
dropout masks are drawn before, in the forward's order, so the recomputed
forward is the first. ``precision`` is "fp32" (TF32 off), "tf32" or "bf16"
(the model in bfloat16 from bfloat16 casts of the fp32 weights, the softmax
and the loss in fp32), as the mclSTExp reference's. Imports torch and
NumPy only (and the mclSTExp reference's shared pieces).
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.harness import load_module

_base = load_module("reference", "mclstexp-her2st")
adam_steps, linear, attention, layer_norm, precision_mode, compute_dtype, cast = (
    _base.adam_steps, _base.linear, _base.attention, _base.layer_norm, _base.precision_mode,
    _base.compute_dtype, _base.cast)
T = "vit.transformer."
JK = T + "jknet.0."
FIXED = tuple(f"{JK}bias_hh_l{layer}" for layer in range(2))
LUMA = (0.299, 0.587, 0.114)
BN_EPS, ZINB_EPS = 1e-5, 1e-10


def parameter_specs(cfg: dict) -> List[tuple]:
    """[(key, shape, init)] under the program's state-dict keys. Init:
    convolutions N(0, 1 / fan_in) (flax's lecun normal, as the program draws
    them) with U(+-1/sqrt(fan_in)) biases, linears and the LSTM U(+-1 /
    sqrt(fan_in)) (torch's), GraphSAGE Glorot-uniform, position tables
    N(0, 1), norms 1 and 0."""
    c, k, dim, g = cfg["channel"], cfg["kernel_size"], cfg["dim"], cfg["n_genes"]
    inner = cfg["heads"] * cfg["dim_head"]
    specs = [("x_embed.weight", (cfg["n_pos"], dim), ("normal", 1.0)),
             ("y_embed.weight", (cfg["n_pos"], dim), ("normal", 1.0))]

    def conv(name, cout, cin, size):
        fan_in = cin * size * size
        specs.append((f"{name}.weight", (cout, cin, size, size), ("normal", math.sqrt(1 / fan_in))))
        specs.append((f"{name}.bias", (cout,), ("uniform", 1 / math.sqrt(fan_in))))

    def bn(name, ch):
        specs.extend([(f"{name}.weight", (ch,), ("const", 1.0)), (f"{name}.bias", (ch,), ("const", 0.0)),
                      (f"{name}.running_mean", (ch,), ("const", 0.0)),
                      (f"{name}.running_var", (ch,), ("const", 1.0)),
                      (f"{name}.num_batches_tracked", (), ("count",))])

    def dense(name, cout, cin, bias=True):
        bound = 1 / math.sqrt(cin)
        specs.append((f"{name}.weight", (cout, cin), ("uniform", bound)))
        if bias:
            specs.append((f"{name}.bias", (cout,), ("uniform", bound)))

    def ln(name, ch):
        specs.extend([(f"{name}.weight", (ch,), ("const", 1.0)), (f"{name}.bias", (ch,), ("const", 0.0))])

    conv("patch_embedding", c, 3, cfg["patch"])
    for i in range(cfg["depth1"]):
        pre = f"{T}layer1.{i}."
        conv(pre + "dw.0", c, 1, k)
        bn(pre + "dw.1", c)
        conv(pre + "dw.3", c, 1, k)
        bn(pre + "dw.4", c)
        conv(pre + "pw.0", c, c, 1)
        bn(pre + "pw.2", c)
    conv(T + "down.0", c // 8, c, 1)
    for i in range(cfg["depth2"]):
        pre = f"{T}layer2.{i}."
        ln(pre + "attn.norm", dim)
        dense(pre + "attn.fn.to_qkv", 3 * inner, dim, bias=False)
        dense(pre + "attn.fn.to_out.0", dim, inner)
        ln(pre + "ff.norm", dim)
        dense(pre + "ff.fn.net.0", cfg["mlp_dim"], dim)
        dense(pre + "ff.fn.net.3", dim, cfg["mlp_dim"])
    for i in range(cfg["depth3"]):
        specs.append((f"{T}layer3.{i}.weight", (dim, dim), ("uniform", math.sqrt(3 / dim))))
    for layer in range(2):
        for kind in ("ih", "hh"):
            specs.append((f"{JK}weight_{kind}_l{layer}", (4 * dim, dim), ("uniform", 1 / math.sqrt(dim))))
        for kind in ("ih", "hh"):
            specs.append((f"{JK}bias_{kind}_l{layer}", (4 * dim,), ("uniform", 1 / math.sqrt(dim))))
    ln("gene_head.0", dim)
    dense("gene_head.1", g, dim)
    for head in ("mean", "disp", "pi"):
        dense(f"{head}.0", g, dim)
    dense("coef.0", dim, dim)
    dense("coef.2", 1, dim)
    return specs


# ---- the data the program is given besides the benchmark's rows ----------

def counts_of(expression: torch.Tensor) -> torch.Tensor:
    """Raw counts of a slide's log-scale expression (log1p of a level):
    round(expm1(expression)), integers in float32 with many zeros."""
    return torch.round(torch.expm1(expression))


def size_factors_of(counts: torch.Tensor) -> torch.Tensor:
    """Each spot's library size over the (lower) median of the non-zero ones."""
    lib = counts.sum(dim=1)
    return lib / lib[lib > 0].median()


def neighbours(position, k: int, prune: str):
    """(rows, cols) NumPy arrays of the k-NN graph's edges over (n, 2) array
    coordinates: each spot's k nearest others by Euclidean distance in
    ``np.argsort`` order (ties as it breaks them), kept within distance 2
    ("grid") or all ("none")."""
    xy = np.asarray(position, dtype=np.float64)
    dist = np.sqrt(((xy[:, None, :] - xy[None, :, :]) ** 2).sum(-1))
    k = min(k, len(xy) - 1)
    near = np.argsort(dist, axis=1)[:, 1:k + 1]
    keep = np.take_along_axis(dist, near, axis=1) <= 2.0 if prune == "grid" else \
        np.ones(near.shape, bool)
    rows = np.repeat(np.arange(len(xy)), k).reshape(near.shape)
    return rows[keep], near[keep]


# ---- the draws ---------------------------------------------------------

def reseeded(device, *key: int) -> torch.Generator:
    """A generator on ``device`` seeded from ``key`` by NumPy's SeedSequence."""
    seed = np.random.SeedSequence(list(key)).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(seed))


def bake_draws(seed: int, n_bake: int):
    """[(grey, angle in degrees (a float32 0-d tensor), flip)] of the bakes."""
    u = torch.rand((n_bake, 3), generator=reseeded("cpu", seed, 0))
    return [(bool(u[i, 0] < 0.1), u[i, 1] * 180.0 - 90.0, bool(u[i, 2] < 0.2))
            for i in range(n_bake)]


def dropout_keeps(cfg, generator, n: int) -> list:
    """The pass's dropout keep masks on the real rows, drawn in the forward's
    order at the padded slide's shapes: the conv maps', then per layer the
    attention output's and the MLP's two. Empty at p = 0 (nothing drawn)."""
    p = cfg["dropout"]
    if p == 0:
        return []
    n_pad = -(-n // cfg["bucket"]) * cfg["bucket"]
    side = cfg["patch_size"] // cfg["patch"]

    def draw(*shape):
        return torch.rand((n_pad, *shape), generator=generator, device=generator.device)[:n] >= p

    keeps = [draw(cfg["channel"], side, side)]
    for _ in range(cfg["depth2"]):
        keeps += [draw(cfg["dim"]), draw(cfg["mlp_dim"]), draw(cfg["dim"])]
    return keeps


def dropout(x, keep, p):
    return x if keep is None else torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def bake(x, grey: bool, angle: torch.Tensor, flip: bool):
    """One bake of float (n, P, P, 3) images (one draw for the slide)."""
    n, h, w = x.shape[:3]
    if grey:
        wts = [float(torch.tensor(c, dtype=torch.float32)) for c in LUMA]
        y = x.double()
        x = (y[..., 0] * wts[0] + y[..., 1] * wts[1] + y[..., 2] * wts[2]).float()
        x = x[..., None].expand(n, h, w, 3)
    theta = angle.to(x.device) * (math.pi / 180.0)
    cos, sin = torch.cos(theta), torch.sin(theta)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy = torch.arange(h, dtype=torch.float32, device=x.device)[:, None].expand(h, w) - cy
    xx = torch.arange(w, dtype=torch.float32, device=x.device)[None, :].expand(h, w) - cx
    sx = torch.round(cos * xx - sin * yy + cx)
    sy = torch.round(sin * xx + cos * yy + cy)
    inside = (sx >= 0) & (sx <= w - 1) & (sy >= 0) & (sy <= h - 1)
    src = sy.clamp(0, h - 1).long() * w + sx.clamp(0, w - 1).long()
    out = x.reshape(n, h * w, 3)[:, src.reshape(-1)].reshape(n, h, w, 3)
    out = torch.where(inside[None, :, :, None], out, torch.zeros((), device=x.device))
    return out.flip(2) if flip else out


# ---- the model ---------------------------------------------------------

def batch_norm(P, name, x):
    """Train mode: the statistics of the real spots (biased variance)."""
    return F.batch_norm(x, None, None, P[f"{name}.weight"], P[f"{name}.bias"], True, 0.0, BN_EPS)


def conv(P, name, x, **kw):
    return F.conv2d(x, P[f"{name}.weight"], P[f"{name}.bias"], **kw)


def trunk(P, cfg, images, keep):
    """(n, P, P, 3) float images -> (n, dim): patchify, dropout, the mixers,
    ``down``, flattened in (c, h, w) order."""
    c, k = cfg["channel"], cfg["kernel_size"]
    x = conv(P, "patch_embedding", images.permute(0, 3, 1, 2), stride=cfg["patch"])
    x = dropout(x, keep, cfg["dropout"])
    for i in range(cfg["depth1"]):
        pre = f"{T}layer1.{i}."
        h = x
        for j in (0, 3):
            h = F.gelu(batch_norm(P, f"{pre}dw.{j + 1}", conv(P, f"{pre}dw.{j}", h, padding=k // 2,
                                                               groups=c)))
        x = batch_norm(P, pre + "pw.2", F.gelu(conv(P, pre + "pw.0", h + x)))
    x = conv(P, T + "down.0", x)
    return x.reshape(x.shape[0], -1)


def transformer_layer(P, cfg, i, x, keeps):
    pre, p = f"{T}layer2.{i}.", cfg["dropout"]
    n, heads, dh = x.shape[0], cfg["heads"], cfg["dim_head"]
    qkv = linear(layer_norm(P, pre + "attn.norm", x), P[pre + "attn.fn.to_qkv.weight"])
    q, k, v = qkv.reshape(n, 3, heads, dh).permute(1, 2, 0, 3)
    o = attention(q, k, v).permute(1, 0, 2).reshape(n, heads * dh)
    o = linear(o, P[pre + "attn.fn.to_out.0.weight"], P[pre + "attn.fn.to_out.0.bias"])
    x = x + dropout(o, keeps[0], p)
    h = layer_norm(P, pre + "ff.norm", x)
    h = dropout(F.gelu(linear(h, P[pre + "ff.fn.net.0.weight"], P[pre + "ff.fn.net.0.bias"])),
                keeps[1], p)
    return x + dropout(linear(h, P[pre + "ff.fn.net.3.weight"], P[pre + "ff.fn.net.3.bias"]),
                       keeps[2], p)


def graph_sage(P, i, x, rows, cols, deg):
    """The neighbours' mean (edge by edge, in fp32), the linear map, ReLU,
    rows over their L2 norm."""
    x32 = x.float()
    neigh = (torch.zeros_like(x32).index_add_(0, rows, x32[cols]) / deg).to(x.dtype)
    h = F.relu(linear(neigh, P[f"{T}layer3.{i}.weight"]))
    return h / h.norm(dim=1, keepdim=True).clamp(min=1e-12)


def jknet(P, seq):
    """The 2-layer LSTM over (steps, n, dim), written out (gates i, f, g, o
    as torch orders them), then the mean of the last layer's outputs over
    the steps."""
    for layer in range(2):
        w_ih, w_hh = P[f"{JK}weight_ih_l{layer}"], P[f"{JK}weight_hh_l{layer}"]
        bias = P[f"{JK}bias_ih_l{layer}"] + P[f"{JK}bias_hh_l{layer}"]
        h = c = torch.zeros_like(seq[0])
        out = []
        for x in seq:
            i, f, g, o = (x @ w_ih.T + h @ w_hh.T + bias).chunk(4, dim=1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            out.append(h)
        seq = torch.stack(out)
    return seq.mean(dim=0)


def forward(P, cfg, images, position, graph, keeps, aug: bool):
    """One train-mode pass over the real spots: (pred, (mean, disp, pi),
    coef on a baked pass else h), every output fp32. ``P`` and ``images``
    in the pass's compute dtype; ``graph`` = (rows, cols, deg)."""
    x = checkpoint(trunk, P, cfg, images, keeps[0] if keeps else None, use_reentrant=False)
    x = x + P["x_embed.weight"][position[:, 0]] + P["y_embed.weight"][position[:, 1]]
    for i in range(cfg["depth2"]):
        layer_keeps = keeps[1 + 3 * i:4 + 3 * i] if keeps else (None,) * 3
        x = checkpoint(transformer_layer, P, cfg, i, x, layer_keeps, use_reentrant=False)
    rows, cols, deg = graph
    jk = []
    for i in range(cfg["depth3"]):
        x = graph_sage(P, i, x, rows, cols, deg)
        jk.append(x)
    h = checkpoint(jknet, P, torch.stack(jk), use_reentrant=False)
    pred = linear(layer_norm(P, "gene_head.0", h), P["gene_head.1.weight"], P["gene_head.1.bias"])
    heads = [linear(h, P[f"{name}.0.weight"], P[f"{name}.0.bias"]).float()
             for name in ("mean", "disp", "pi")]
    zinb = (torch.clamp(torch.exp(heads[0]), 1e-5, 1e6),
            torch.clamp(F.softplus(heads[1]), 1e-4, 1e4), torch.sigmoid(heads[2]))
    if aug:
        coef = linear(F.relu(linear(h, P["coef.0.weight"], P["coef.0.bias"])), P["coef.2.weight"],
                      P["coef.2.bias"])
        return pred.float(), zinb, coef.float()
    return pred.float(), zinb, h.float()


def zinb_nll(x, mean, disp, pi, size_factors):
    """The mean ZINB negative log-likelihood (upstream ``NB_module.ZINB``,
    ridge 0): the zero branch where the count is 0."""
    mean = mean * size_factors[:, None]
    t1 = torch.lgamma(disp + ZINB_EPS) + torch.lgamma(x + 1.0) - torch.lgamma(x + disp + ZINB_EPS)
    t2 = (disp + x) * torch.log1p(mean / (disp + ZINB_EPS)) + x * (
        torch.log(disp + ZINB_EPS) - torch.log(mean + ZINB_EPS))
    nb_case = t1 + t2 - torch.log(1.0 - pi + ZINB_EPS)
    zero_nb = torch.pow(disp / (disp + mean + ZINB_EPS), disp)
    zero_case = -torch.log(pi + (1.0 - pi) * zero_nb + ZINB_EPS)
    return torch.where(x <= 1e-8, zero_case, nb_case).mean()


def slide_loss(P, cfg, slide, generator, graph, precision="fp32"):
    """The step's loss on one slide's real spots (``slide``: "image_u8",
    "position", "expression"), its dropout from ``generator``."""
    dt = compute_dtype(precision)
    Pc = cast(P, dt)
    u8, position, expr = slide["image_u8"], slide["position"], slide["expression"]
    n, seed = u8.shape[0], generator.initial_seed()
    images = u8.float() * torch.tensor(1.0 / 255.0, dtype=torch.float32, device=u8.device)
    pred, zinb, _ = forward(Pc, cfg, images.to(dt), position, graph,
                            dropout_keeps(cfg, generator, n), aug=False)
    counts = counts_of(expr)
    loss = (pred - expr).square().mean() + cfg["zinb"] * zinb_nll(counts, *zinb,
                                                                  size_factors_of(counts))
    preds, coefs = [], []
    for i, draw in enumerate(bake_draws(seed, cfg["bake"])):
        keeps = dropout_keeps(cfg, reseeded(generator.device, seed, i + 1), n)
        bp, _, bc = forward(Pc, cfg, bake(images, *draw).to(dt), position, graph, keeps, aug=True)
        preds.append(bp)
        coefs.append(bc)
    if preds:
        new_pred = (torch.stack(preds) * torch.softmax(torch.stack(coefs), dim=0)).sum(dim=0)
        loss = loss + cfg["lamb"] * (new_pred - pred).square().mean()
    return loss


def spot_graph(cfg, position):
    rows, cols = neighbours(position.cpu().numpy(), cfg["knn_k"], cfg["knn_prune"])
    rows, cols = (torch.from_numpy(a).to(position.device) for a in (rows, cols))
    deg = torch.zeros(len(position), device=position.device).index_add_(
        0, rows, torch.ones(len(rows), device=position.device)).clamp(min=1.0)[:, None]
    return rows, cols, deg


def train_steps(weights, keys, cfg, slides, generators, precision="fp32") -> dict:
    """Adam steps, one slide each: ``slides`` [{"image_u8", "position",
    "expression"} of the real spots], ``generators`` each step's dropout
    generator, seeded as the port's step was. The fixed ``bias_hh`` are
    left out of ``keys``."""
    keys = [k for k in keys if k not in FIXED]
    graphs = {}

    def loss_fn(P, t):
        s = slides[t]
        key = (s["position"].data_ptr(), len(s["position"]))
        if key not in graphs:
            graphs[key] = spot_graph(cfg, s["position"])
        return slide_loss(P, cfg, s, generators[t], graphs[key], precision)

    with precision_mode(precision):
        return adam_steps(weights, keys, cfg, loss_fn, len(slides))
