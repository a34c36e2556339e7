"""The port's ring attention (``parallel/ring_attention.py``) and the
flagship step under a ("data", "seq") mesh, against the JAX package and
one process, on the CPU.

One gloo job at world size 2, one at 3 and one at 4, every rank a process
started once for this module (``tests/_torch_port_gloo.py::run_ring``; a
``FileStore`` rendezvous, no TCP port). At worlds 2 and 3 each rank runs
``ring_self_attention`` over the world group on its blocks of (n, h, d) =
(24, 4, 16) q, k, v (fp32, then bf16) with the gradient of sum(out *
upstream), ``MclSTExp.encode_spots`` with attn_backend "ring" under
``active_mesh`` of a (1, world) ("data", "seq") mesh, and one flagship step
(tiny_cnn, augment "none", dropout 0.1, batch 12) under that mesh; at world
4 the step under a (2, 2) mesh.

Against JAX (its ring under ``shard_map`` on 2 or 3 of the conftest's CPU
devices, ``jax.grad`` through it; its "xla" spot tower with the same
weights through ``interop.params_from_jax``): outputs within atol 2e-5 (the
JAX tests' tolerance), gradients within 2e-5 of each tensor's largest
magnitude (the port's gradient is computed analytically, JAX's through its
loop), bf16 outputs bf16 and within 2^-7 of their largest magnitude (one
bf16 rounding of two fp32 results 2e-5 apart). Against one process (the
"xla" step on the global batch, no mesh): the gradients before Adam within
1e-5 of each tensor's largest magnitude, the loss and every parameter after
Adam within rtol 2e-5 / atol 2e-6 (tests/test_tp.py's tolerances), every
rank the same bits.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from mclstexp_tpu.config import Config as JaxConfig
from mclstexp_tpu.config import ModelConfig as JaxModelConfig
from mclstexp_tpu.config import TrainConfig as JaxTrainConfig
from mclstexp_tpu.data import synthetic as jax_synthetic
from mclstexp_tpu.models.mclstexp import MclSTExp as JaxMclSTExp
from mclstexp_tpu.parallel import ring_attention as jax_ring
from mclstexp_tpu.train import loop as jax_loop
from mclstexp_tpu.utils.logging import MetricLogger as JaxLogger
from mclstexp_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from mclstexp_tpu_torch.data import synthetic
from mclstexp_tpu_torch.interop import params_from_jax
from mclstexp_tpu_torch.parallel import distributed
from mclstexp_tpu_torch.parallel import ring_attention as ring
from mclstexp_tpu_torch.parallel.mesh import make_mesh
from mclstexp_tpu_torch.train import loop
from mclstexp_tpu_torch.utils.logging import MetricLogger
from _torch_port_gloo import step_outcome

try:
    from jax import shard_map
except ImportError:  # older jax
    from jax.experimental.shard_map import shard_map

torch.set_num_threads(1)

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
WORLDS = (2, 3, 4)
ATOL = 2e-5  # outputs against JAX (tests/test_ring_attention.py)
GRAD_RTOL = 2e-5  # gradients against jax.grad, of each tensor's largest magnitude
STEP_GRAD_RTOL = 1e-5  # the step's gradients against one process
SPOTS = dict(encoder_name="tiny_cnn", image_dim=128, spot_dim=16, projection_dim=8,
             heads_num=2, heads_dim=4, head_layers=2, pos_vocab=64)
MESHES = {2: [(1, 2)], 3: [(1, 3)], 4: [(2, 2)]}


def _attention_inputs(seed=0, n=24, h=4, d=16):
    rng = np.random.default_rng(seed)
    return {name: rng.normal(size=(n, h, d)).astype(np.float32)
            for name in ("q", "k", "v", "upstream")}


def _step_batch(seed=5, n=12):
    rng = np.random.default_rng(seed)
    return {"image_u8": torch.from_numpy(rng.integers(0, 256, size=(n, 16, 16, 3))
                                         .astype(np.uint8)),
            "expression": torch.from_numpy(rng.normal(size=(n, 16)).astype(np.float32)),
            "position": torch.from_numpy(rng.integers(0, 64, size=(n, 2)))}


def _jax_spot_model():
    """(JAX "xla" model's variables, numpy spot inputs of 12 spots)."""
    rng = np.random.default_rng(4)
    batch = {"image": np.zeros((12, 16, 16, 3), np.float32),
             "expression": rng.normal(size=(12, 16)).astype(np.float32),
             "position": rng.integers(0, 64, size=(12, 2)).astype(np.int32)}
    variables = jax.device_get(JaxMclSTExp(JaxModelConfig(**SPOTS)).init(
        jax.random.PRNGKey(0), batch))
    return variables, batch


def _inputs():
    variables, batch = _jax_spot_model()
    return dict(
        attention=_attention_inputs(),
        spots=dict(cfg=SPOTS, expression=batch["expression"], position=batch["position"],
                   state_dict=params_from_jax(variables["params"], {}, ModelConfig(**SPOTS))),
        step=dict(cfg=dict(SPOTS, dropout=0.1), train=dict(batch_size=12), batch=_step_batch(),
                  meshes=MESHES),
    )


@pytest.fixture(scope="module")
def ring_job(tmp_path_factory):
    """The three jobs at once, every rank a process of its own."""
    work = str(tmp_path_factory.mktemp("ring"))
    inputs = _inputs()
    torch.save(inputs, os.path.join(work, "ring_job_inputs.pt"))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([TESTS, REPO]), CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c",
                               f"import _torch_port_gloo; _torch_port_gloo.run_ring({r}, {w}, "
                               f"{work!r})"],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for w in WORLDS for r in range(w)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    results = {w: [torch.load(os.path.join(work, f"ring_job_result_{w}_{r}.pt"),
                              weights_only=False) for r in range(w)] for w in WORLDS}
    return dict(inputs=inputs, results=results)


def _close(got, want, rtol, what=""):
    """Within ``rtol`` of the largest magnitude of ``want``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * float(np.abs(want).max()),
                               err_msg=what)


def _jax_ring(world):
    """JAX's ring over ``world`` CPU devices under ``shard_map``."""
    mesh = Mesh(np.array(jax.devices()[:world]), ("seq",))
    return jax.jit(shard_map(lambda q, k, v: jax_ring.ring_self_attention(q, k, v, "seq"),
                             mesh=mesh, in_specs=(P("seq"),) * 3, out_specs=P("seq"),
                             check_vma=False))


@pytest.mark.parametrize("world", [2, 3])
def test_ring_matches_jax_shard_map(ring_job, world):
    """Each rank's output block is JAX's, and its q, k, v gradient blocks
    are ``jax.grad`` of sum(out * upstream) through JAX's ring."""
    att = ring_job["inputs"]["attention"]
    fn = _jax_ring(world)
    q, k, v, g = (jnp.asarray(att[name]) for name in ("q", "k", "v", "upstream"))
    want = np.asarray(fn(q, k, v))
    grads = [np.asarray(x) for x in jax.grad(lambda q, k, v: (fn(q, k, v) * g).sum(),
                                             argnums=(0, 1, 2))(q, k, v)]
    got = [np.concatenate(parts) for parts in zip(*(r["ring"] for r in
                                                    ring_job["results"][world]))]
    np.testing.assert_allclose(got[0], want, atol=ATOL)
    for name, mine, theirs in zip("qkv", got[1:], grads):
        _close(mine, theirs, GRAD_RTOL, f"d{name}")


@pytest.mark.parametrize("world", [2, 3])
def test_ring_in_bfloat16_matches_jax(ring_job, world):
    """bf16 q, k, v: a bf16 output (fp32 inside), JAX's within one bf16
    rounding."""
    att = ring_job["inputs"]["attention"]
    q, k, v = (jnp.asarray(att[name], jnp.bfloat16) for name in "qkv")
    want = _jax_ring(world)(q, k, v)
    assert want.dtype == jnp.bfloat16
    got = np.concatenate([r["ring_bf16"] for r in ring_job["results"][world]])
    _close(got, np.asarray(want, np.float32), 2.0**-7)
    q16 = torch.from_numpy(att["q"]).bfloat16()
    assert ring.blockwise_self_attention(q16, q16, q16, world).dtype == torch.bfloat16


def _dense_grads(q, k, v, g):
    """Dense attention's output and q, k, v gradients in float64."""
    q, k, v = (torch.tensor(x, dtype=torch.float64, requires_grad=True) for x in (q, k, v))
    out = ring.dense_reference_attention(*(x.detach().float() for x in (q, k, v)))
    s = torch.einsum("qhd,khd->hqk", q, k) * q.shape[-1] ** -0.5
    exact = torch.einsum("hqk,khd->hqd", s.softmax(-1), v).transpose(0, 1)
    grads = torch.autograd.grad((exact * torch.from_numpy(g).double()).sum(), (q, k, v))
    return out, exact.detach(), grads


def test_ring_at_world_one_is_dense_attention():
    """A one-rank group sends nothing: the ring is one block, dense
    attention (JAX's ``test_ring_attention_single_device``); the port's
    oracle is JAX's."""
    att = _attention_inputs(seed=1, n=16, h=2, d=8)
    dense, exact, grads = _dense_grads(att["q"], att["k"], att["v"], att["upstream"])
    want = np.asarray(jax_ring.dense_reference_attention(*(jnp.asarray(att[x]) for x in "qkv")))
    np.testing.assert_allclose(dense.numpy(), want, atol=ATOL)
    q, k, v = (torch.tensor(att[x], requires_grad=True) for x in "qkv")
    try:
        out = ring.ring_self_attention(q, k, v, make_mesh(device="cpu").get_group(0))
        (out * torch.from_numpy(att["upstream"])).sum().backward()
    finally:
        distributed.shutdown()
    np.testing.assert_allclose(out.detach().numpy(), want, atol=ATOL)
    for name, x, w in zip("qkv", (q, k, v), grads):
        _close(x.grad.numpy(), w.numpy(), GRAD_RTOL, f"d{name}")


@pytest.mark.parametrize("n_blocks", [1, 2, 3, 4])
def test_blockwise_schedule_is_dense_attention(n_blocks):
    """The ring's schedule over S blocks of one process's sequence (what
    S ranks compute), forward and backward, against dense attention."""
    att = _attention_inputs(seed=2)
    _, exact, grads = _dense_grads(att["q"], att["k"], att["v"], att["upstream"])
    q, k, v = (torch.tensor(att[x], requires_grad=True) for x in "qkv")
    out = ring.blockwise_self_attention(q, k, v, n_blocks)
    (out * torch.from_numpy(att["upstream"])).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), exact.numpy(), atol=ATOL)
    for name, x, w in zip("qkv", (q, k, v), grads):
        _close(x.grad.numpy(), w.numpy(), GRAD_RTOL, f"d{name}")
    with pytest.raises(ValueError, match="blocks"):
        ring.blockwise_self_attention(q[:5], k[:5], v[:5], 2)


@pytest.mark.parametrize("world", [2, 3])
def test_ring_spot_tower_matches_jax_xla(ring_job, world):
    """``encode_spots`` with "ring" under a (1, world) ("data", "seq") mesh
    is JAX's "xla" spot tower with the same weights (the port of
    ``test_ring_backend_through_model``), on every rank; 8 spots on a ring
    of 3 raise JAX's ValueError."""
    spots = ring_job["inputs"]["spots"]
    variables, _ = _jax_spot_model()
    want = np.asarray(JaxMclSTExp(JaxModelConfig(**SPOTS)).apply(
        variables, spots["expression"], spots["position"], method=JaxMclSTExp.encode_spots))
    for out in ring_job["results"][world]:
        np.testing.assert_allclose(out["encode_spots"], want, atol=ATOL)
        if world == 3:
            assert out["undivided"] == "sequence length 8 must divide the 'seq' axis (3)"
        else:
            assert out["undivided"] == "no error"


@pytest.mark.parametrize("world,shape", [(w, s) for w, shapes in MESHES.items() for s in shapes])
def test_seq_parallel_step_equals_one_process(ring_job, world, shape):
    """One flagship step under a ("data", "seq") mesh: the batch sharded on
    "data", the spot tower's ring over "seq", the gradient average over the
    "data" group only; the one-process "xla" step on the global batch."""
    step = ring_job["inputs"]["step"]
    cfg, tcfg = ModelConfig(**step["cfg"]), TrainConfig(**step["train"])
    loss, grads, after, _ = step_outcome(cfg, tcfg, step["batch"])
    ranks = ring_job["results"][world]
    first = ranks[0][("step", shape)]
    for out in ranks:
        got_loss, got_grads, got_after = out[("step", shape)]
        np.testing.assert_allclose(got_loss, loss, rtol=2e-5)
        assert sorted(got_grads) == sorted(grads)
        for name, g in grads.items():
            _close(got_grads[name].numpy(), g.numpy(), STEP_GRAD_RTOL, name)
        for name, p in after.items():
            np.testing.assert_allclose(got_after[name].numpy(), p.numpy(), rtol=2e-5,
                                       atol=2e-6, err_msg=name)
            assert torch.equal(got_after[name], first[2][name]), name
        assert got_loss == first[0]


def test_train_fold_with_ring_raises_like_jax(tmp_path):
    """JAX's ``train_fold`` enters no ``with mesh:``, so a "ring" model
    raises ``_ring_shard_map``'s ValueError (at ``create_train_state``);
    the port's ``train_fold`` enters no ``active_mesh`` and raises the same
    at its first step."""
    kw = dict(SPOTS, attn_backend="ring")
    jax_sections = jax_synthetic.make_dataset(num_sections=2, num_spots=12, num_genes=16,
                                              patch_size=16)
    jax_cfg = JaxConfig(model=JaxModelConfig(**kw),
                        train=JaxTrainConfig(batch_size=8, max_epochs=1,
                                             checkpoint_dir=str(tmp_path / "jax")))
    with pytest.raises(ValueError, match="needs an active mesh with a 'seq' axis"):
        jax_loop.train_fold(jax_cfg, jax_sections, 0, logger=JaxLogger(echo=False))
    sections = synthetic.make_dataset(num_sections=2, num_spots=12, num_genes=16,
                                      patch_size=16)
    cfg = Config(model=ModelConfig(**kw),
                 train=TrainConfig(batch_size=8, max_epochs=1,
                                   checkpoint_dir=str(tmp_path / "port")),
                 data=DataConfig(dataset="synthetic", patch_size=16))
    with pytest.raises(ValueError, match="needs an active mesh with a 'seq' axis"):
        loop.train_fold(cfg, sections, 0, MetricLogger(echo=False), device="cpu")
    assert not os.path.exists(tmp_path / "port" / "synthetic")
