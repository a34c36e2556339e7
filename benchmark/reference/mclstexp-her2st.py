"""Plain PyTorch reference of mclSTExp (Min, Shi et al., Brief. Bioinform.
25(6):bbae551; upstream ``model.py``, ``train.py``, ``evel_her2st.py``):
the "st" augmentation, the DenseNet121 image tower, the spot tower over the
batch as one sequence, both projection heads, symmetric InfoNCE, torch
Adam with coupled L2, and the retrieval prediction (cosine top-K, 1/d^2
weights with the L1 distance).

Functions of a state dict keyed as the upstream torch model
(``image_encoder.model.0.denseblock1.denselayer1.conv1.weight``, ...).
Imports torch only. ``precision`` is "fp32" (TF32 off), "tf32" (TF32 on)
or "bf16" (the towers and heads computed in bfloat16 from bfloat16 casts of
the fp32 weights, softmax and the loss in fp32, as a bf16 model runs): the
last two serve as the check's controls.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List

import torch
import torch.nn.functional as F

LUMA = (0.299, 0.587, 0.114)
PERMS = ((0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0))
TOWER = "image_encoder.model.0."
HEADS = ("image_projection", "spot_projection")
BETAS, EPS_ADAM = (0.9, 0.999), 1e-8


# ---- the architecture's parameters -------------------------------------

def parameter_specs(cfg: dict) -> List[tuple]:
    """[(key, shape, init)] of every parameter and batch-norm statistic.
    Init: convolutions N(0, 2 / fan_out), linears U(+-1/sqrt(fan_in)),
    position tables N(0, 1), norms 1 and 0."""
    specs = []

    def conv(name, cout, cin, k):
        specs.append((f"{name}.weight", (cout, cin, k, k), ("normal", math.sqrt(2.0 / (cout * k * k)))))

    def bn(name, c):
        specs.extend([(f"{name}.weight", (c,), ("const", 1.0)), (f"{name}.bias", (c,), ("const", 0.0)),
                      (f"{name}.running_mean", (c,), ("const", 0.0)),
                      (f"{name}.running_var", (c,), ("const", 1.0)),
                      (f"{name}.num_batches_tracked", (), ("count",))])

    def linear(name, cout, cin, bias=True):
        bound = 1.0 / math.sqrt(cin)
        specs.append((f"{name}.weight", (cout, cin), ("uniform", bound)))
        if bias:
            specs.append((f"{name}.bias", (cout,), ("uniform", bound)))

    def ln(name, c):
        specs.extend([(f"{name}.weight", (c,), ("const", 1.0)), (f"{name}.bias", (c,), ("const", 0.0))])

    g, v = cfg["spot_dim"], cfg["pos_vocab"]
    specs.append(("x_embed.weight", (v, g), ("normal", 1.0)))
    specs.append(("y_embed.weight", (v, g), ("normal", 1.0)))
    growth, width = cfg["growth_rate"], cfg["bn_size"] * cfg["growth_rate"]
    c = cfg["init_features"]
    conv(TOWER + "conv0", c, 3, 7)
    bn(TOWER + "norm0", c)
    blocks = cfg["block_config"]
    for bi, layers in enumerate(blocks):
        for li in range(layers):
            pre = f"{TOWER}denseblock{bi + 1}.denselayer{li + 1}."
            bn(pre + "norm1", c + li * growth)
            conv(pre + "conv1", width, c + li * growth, 1)
            bn(pre + "norm2", width)
            conv(pre + "conv2", growth, width, 3)
        c += layers * growth
        if bi != len(blocks) - 1:
            bn(f"{TOWER}transition{bi + 1}.norm", c)
            conv(f"{TOWER}transition{bi + 1}.conv", c // 2, c, 1)
            c //= 2
    bn(TOWER + "norm5", c)
    inner = cfg["heads_num"] * cfg["heads_dim"]
    for i in range(cfg["head_layers"]):
        pre = f"spot_encoder.{i}."
        ln(pre + "attn.norm", g)
        linear(pre + "attn.fn.to_qkv", 3 * inner, g, bias=False)
        linear(pre + "attn.fn.to_out.0", g, inner)
        ln(pre + "ff.norm", g)
        linear(pre + "ff.fn.net.0", g, g)
        linear(pre + "ff.fn.net.3", g, g)
    p = cfg["projection_dim"]
    for head, width_in in zip(HEADS, (cfg["image_dim"], g)):
        linear(f"{head}.projection", p, width_in)
        linear(f"{head}.fc", p, p)
        ln(f"{head}.layer_norm", p)
    return specs


# ---- precision ----------------------------------------------------------

@contextlib.contextmanager
def precision_mode(precision: str):
    """TF32 on for "tf32", off otherwise, restored after."""
    cuda, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    old = cuda.allow_tf32, cudnn.allow_tf32
    cuda.allow_tf32 = cudnn.allow_tf32 = precision == "tf32"
    try:
        yield
    finally:
        cuda.allow_tf32, cudnn.allow_tf32 = old


def compute_dtype(precision: str) -> torch.dtype:
    return torch.bfloat16 if precision == "bf16" else torch.float32


def cast(P: dict, dtype: torch.dtype) -> dict:
    """The floating entries of ``P`` in ``dtype`` (a differentiable cast)."""
    return {k: v.to(dtype) if v.is_floating_point() else v for k, v in P.items()}


def linear(x, w, b=None):
    return F.linear(x, w, b)


# ---- augmentation -------------------------------------------------------

def _gray(x):  # (B, H, W, 3) -> (B, H, W, 1)
    return (x[..., 0] * LUMA[0] + x[..., 1] * LUMA[1] + x[..., 2] * LUMA[2])[..., None]


def _blend(a, b, f):
    return (f * a + (1.0 - f) * b).clamp(0.0, 1.0)


def color_jitter(x, factors, order):
    """torchvision ColorJitter(0.5, 0.5, 0.5) with per-image factors (B, 3)
    and per-image order of brightness, contrast, saturation."""
    f = factors.float()[:, :, None, None, None]
    perms = torch.tensor(PERMS, device=x.device)[order.long()]
    for step in range(3):
        ops = (_blend(x, torch.zeros_like(x), f[:, 0]),
               _blend(x, _gray(x).mean(dim=(1, 2, 3), keepdim=True), f[:, 1]),
               _blend(x, _gray(x), f[:, 2]))
        which = perms[:, step][:, None, None, None]
        x = torch.where(which == 0, ops[0], torch.where(which == 1, ops[1], ops[2]))
    return x


def shear_rows(x, shift):
    """out[b, y, x] = in[b, y, x - shift[b, y]], zero outside; shifts are
    clamped to half the width."""
    b, h, w, c = x.shape
    k = shift.long().clamp(-(w // 2), w // 2)
    src = torch.arange(w, device=x.device) - k[..., None]
    valid = (src >= 0) & (src < w)
    out = torch.gather(x, 2, src.clamp(0, w - 1)[..., None].expand(b, h, w, c))
    return torch.where(valid[..., None], out, torch.zeros_like(out))


def rotate_paeth(x, angles):
    """Rotation of square (B, S, S, C) images by ``angles`` degrees (positive
    counter-clockwise): k quarter turns, then the residual t in [-45, 45]
    as Paeth's three shears, x by round(tan(t/2) c), y by round(-sin(t) c),
    x again, c the centred row or column index."""
    size = x.shape[1]
    k90 = torch.round(angles / 90.0)
    theta = (angles - k90 * 90.0) * (math.pi / 180.0)
    centered = torch.arange(size, dtype=torch.float32, device=x.device) - (size - 1) / 2.0
    a = torch.round(torch.tan(theta / 2.0)[:, None] * centered)
    b = torch.round(-torch.sin(theta)[:, None] * centered)
    k = torch.remainder(k90, 4).long()[:, None, None, None]
    turned = [torch.rot90(x, q, dims=(1, 2)) for q in range(4)]
    x = torch.where(k == 0, turned[0], torch.where(k == 1, turned[1],
                                                   torch.where(k == 2, turned[2], turned[3])))
    x = shear_rows(x, a)
    x = shear_rows(x.transpose(1, 2), b).transpose(1, 2)
    return shear_rows(x, a)


def augment(patches_u8, draws):
    """uint8 patches -> jittered, flipped, rotated float [0, 1]."""
    x = patches_u8.float() / 255.0
    x = color_jitter(x, draws["jitter"], draws["order"])
    x = torch.where(draws["hflip"][:, None, None, None], x.flip(2), x)
    return rotate_paeth(x, draws["angles"].float())


# ---- the model ----------------------------------------------------------

def batch_norm(P, name, x, train, stats=None):
    """Batch statistics in train mode (and, with ``stats``, recorded as
    name -> (mean, unbiased var)), the running ones in eval mode."""
    if train:
        if stats is not None:
            stats[name] = (x.mean(dim=(0, 2, 3)), x.var(dim=(0, 2, 3), unbiased=True))
        return F.batch_norm(x, None, None, P[f"{name}.weight"], P[f"{name}.bias"], True, 0.0, 1e-5)
    return F.batch_norm(x, P[f"{name}.running_mean"], P[f"{name}.running_var"],
                        P[f"{name}.weight"], P[f"{name}.bias"], False, 0.0, 1e-5)


def image_tower(P, cfg, images, train=True, stats=None):
    """(B, H, W, 3) -> (B, image_dim) in the dtype of ``P`` and ``images``:
    DenseNet's features through norm5 (no ReLU after it), then the spatial
    mean."""
    def bn_relu(name, x):
        return F.relu(batch_norm(P, name, x, train, stats))

    x = images.permute(0, 3, 1, 2)
    x = F.conv2d(x, P[TOWER + "conv0.weight"], stride=2, padding=3)
    x = F.max_pool2d(bn_relu(TOWER + "norm0", x), 3, 2, 1)
    blocks = cfg["block_config"]
    for bi, layers in enumerate(blocks):
        feats = [x]
        for li in range(layers):
            pre = f"{TOWER}denseblock{bi + 1}.denselayer{li + 1}."
            h = F.conv2d(bn_relu(pre + "norm1", torch.cat(feats, 1)), P[pre + "conv1.weight"])
            feats.append(F.conv2d(bn_relu(pre + "norm2", h), P[pre + "conv2.weight"], padding=1))
        x = torch.cat(feats, 1)
        if bi != len(blocks) - 1:
            pre = f"{TOWER}transition{bi + 1}."
            x = F.conv2d(bn_relu(pre + "norm", x), P[pre + "conv.weight"])
            x = F.avg_pool2d(x, 2, 2)
    return batch_norm(P, TOWER + "norm5", x, train, stats).mean(dim=(2, 3))


def layer_norm(P, name, x):
    return F.layer_norm(x, x.shape[-1:], P[f"{name}.weight"], P[f"{name}.bias"], 1e-5)


def head(P, name, x):
    projected = linear(x, P[f"{name}.projection.weight"], P[f"{name}.projection.bias"])
    h = linear(F.gelu(projected), P[f"{name}.fc.weight"], P[f"{name}.fc.bias"])
    return layer_norm(P, f"{name}.layer_norm", h + projected)


def attention(q, k, v):
    """Softmax attention over (..., n, d), scale d^-0.5, the softmax in fp32."""
    s = (q @ k.transpose(-1, -2)).float() * q.shape[-1] ** -0.5
    return torch.softmax(s, dim=-1).to(v.dtype) @ v


def spot_tower(P, cfg, expression, position):
    """(B, G) expression + position tables -> (B, G): the pre-LN blocks over
    the batch as one sequence."""
    x = (expression + P["x_embed.weight"][position[:, 0]] + P["y_embed.weight"][position[:, 1]])
    n, heads, dh = x.shape[0], cfg["heads_num"], cfg["heads_dim"]
    for i in range(cfg["head_layers"]):
        pre = f"spot_encoder.{i}."
        qkv = linear(layer_norm(P, pre + "attn.norm", x), P[pre + "attn.fn.to_qkv.weight"])
        q, k, v = qkv.reshape(n, 3, heads, dh).permute(1, 2, 0, 3)
        o = attention(q, k, v).permute(1, 0, 2).reshape(n, heads * dh)
        x = x + linear(o, P[pre + "attn.fn.to_out.0.weight"], P[pre + "attn.fn.to_out.0.bias"])
        h = layer_norm(P, pre + "ff.norm", x)
        h = F.gelu(linear(h, P[pre + "ff.fn.net.0.weight"], P[pre + "ff.fn.net.0.bias"]))
        x = x + linear(h, P[pre + "ff.fn.net.3.weight"], P[pre + "ff.fn.net.3.bias"])
    return x


def embed_images(P, cfg, images, train=False, precision="fp32"):
    """(B, P) fp32 embeddings of float [0, 1] images, computed in
    ``precision``'s dtype."""
    dt = compute_dtype(precision)
    Pc = cast(P, dt)
    return head(Pc, "image_projection", image_tower(Pc, cfg, images.to(dt), train)).float()


def embed_spots(P, cfg, expression, position, precision="fp32"):
    dt = compute_dtype(precision)
    Pc = cast(P, dt)
    return head(Pc, "spot_projection", spot_tower(Pc, cfg, expression.to(dt), position)).float()


def infonce(spot, image, temperature):
    logits = spot @ image.T / temperature
    labels = torch.arange(logits.shape[0], device=logits.device)
    return (F.cross_entropy(logits, labels) + F.cross_entropy(logits.T, labels)) / 2.0


def loss_of(P, cfg, batch, draws, precision="fp32"):
    images = augment(batch["image_u8"], draws)
    image = embed_images(P, cfg, images, train=True, precision=precision)
    spot = embed_spots(P, cfg, batch["expression"], batch["position"], precision)
    return infonce(spot, image, cfg["temperature"])


# ---- training -----------------------------------------------------------

def adam_steps(weights: Dict[str, torch.Tensor], keys, cfg, loss_fn, n_steps: int) -> dict:
    """``n_steps`` steps of torch Adam with coupled L2 from ``weights``;
    loss_fn(P, t) is step t's loss. Returns the losses, the norm of each
    leaf's first gradient as Adam takes it (decay included) and of each
    leaf's change after the steps."""
    lr, wd = cfg["lr"], cfg["weight_decay"]
    P = {k: v.detach().clone() for k, v in weights.items()}
    start = {k: P[k].clone() for k in keys}
    m = {k: torch.zeros_like(P[k]) for k in keys}
    v = {k: torch.zeros_like(P[k]) for k in keys}
    losses, first = [], {}
    for t in range(n_steps):
        for k in keys:
            P[k].requires_grad_(True)
        loss = loss_fn(P, t)
        grads = torch.autograd.grad(loss, [P[k] for k in keys])
        losses.append(float(loss.detach()))
        with torch.no_grad():
            for k, g in zip(keys, grads):
                p = P[k].detach()
                g = g + wd * p
                if t == 0:
                    first[k] = float(g.norm())
                m[k] = BETAS[0] * m[k] + (1 - BETAS[0]) * g
                v[k] = BETAS[1] * v[k] + (1 - BETAS[1]) * g * g
                mhat = m[k] / (1 - BETAS[0] ** (t + 1))
                vhat = v[k] / (1 - BETAS[1] ** (t + 1))
                P[k] = p - lr * mhat / (vhat.sqrt() + EPS_ADAM)
        del loss, grads
    change = {k: float((P[k] - start[k]).norm()) for k in keys}
    return {"losses": losses, "grad_norms": first, "change_norms": change}


def train_steps(weights, keys, cfg, batches, draws, precision="fp32") -> dict:
    with precision_mode(precision):
        return adam_steps(weights, keys, cfg,
                          lambda P, t: loss_of(P, cfg, batches[t], draws[t], precision),
                          len(batches))


# ---- serving ------------------------------------------------------------

@torch.no_grad()
def batch_stats(weights, cfg, images_u8) -> Dict[str, torch.Tensor]:
    """Running statistics for eval mode: each batch norm's mean and unbiased
    variance over ``images_u8`` in a train-mode forward, as state-dict
    entries."""
    stats = {}
    with precision_mode("fp32"):
        image_tower(weights, cfg, images_u8.float() / 255.0, True, stats)
    out = {}
    for name, (mean, var) in stats.items():
        out[f"{name}.running_mean"], out[f"{name}.running_var"] = mean, var
    return out


@torch.no_grad()
def spot_keys(weights, cfg, expression, position, batch: int, precision="fp32"):
    """The database's key embeddings: the spot tower over consecutive
    sequences of ``batch`` spots."""
    with precision_mode(precision):
        return torch.cat([embed_spots(weights, cfg, expression[s:s + batch],
                                      position[s:s + batch], precision)
                          for s in range(0, len(expression), batch)])


@torch.no_grad()
def predict(weights, cfg, keys, key_expr, patches_u8, precision="fp32", block: int = 256):
    """(B, G) predictions for uint8 query patches: eval-mode image tower,
    cosine top-K over ``keys``, weights 1/d^2 of the L1 (weight_ord 1) or
    L2 distance between unnormalized embeddings, normalized."""
    out = []
    with precision_mode(precision):
        for s in range(0, len(patches_u8), block):
            q = embed_images(weights, cfg, patches_u8[s:s + block].float() / 255.0, False,
                             precision)
            scores = F.normalize(q, dim=-1) @ F.normalize(keys, dim=-1).T
            idx = torch.topk(scores, cfg["top_k"], dim=1).indices
            diff = keys[idx] - q[:, None, :]
            d = diff.abs().sum(-1) if cfg["weight_ord"] == 1 else diff.square().sum(-1).sqrt()
            w = 1.0 / d.square()
            w = w / w.sum(dim=-1, keepdim=True)
            out.append(torch.einsum("qk,qkg->qg", w, key_expr[idx]))
    return torch.cat(out)
