"""Retrieval parity: ``mclstexp_tpu_torch/ops/retrieval.py`` against the JAX
package's ``ops/retrieval.py`` on the same numpy inputs, on the CPU.

Tolerances: the selected indices are held EXACT (ties included: JAX's
``lax.top_k`` gives tied scores to the lowest index, and so must the port,
in the dense path and in the streaming merge); predictions to rtol 1e-5
(both fp32, sums taken in another order), with atol 1e-6 for the embedding
average, whose entries can sit near zero.

The tie-heavy key sets draw their rows, with replacement, from signed and
scaled basis vectors: normalized, each is exactly a unit vector, so every
score is exactly one entry of the normalized query in both packages and
the ties are real in both. (Copies of random rows are no such test: the
two packages normalize them to different last bits, and XLA's product can
score two copies differently.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mclstexp_tpu.ops import retrieval as jret
from mclstexp_tpu_torch.ops import retrieval

torch.set_num_threads(1)

PRED_TOL = dict(rtol=1e-5, atol=0)
EMB_TOL = dict(rtol=1e-5, atol=1e-6)


def _random_keys(r, nk, nq, d):
    return (r.normal(size=(nk, d)).astype(np.float32),
            r.normal(size=(nq, d)).astype(np.float32))


def _tied_keys(r, nk, nq, d):
    """nk keys drawn from the 2d signed basis directions, each scaled by a
    power of two (exact norms): groups of ~nk/2d exactly tied scores."""
    axis = r.integers(0, d, size=nk)
    key = np.zeros((nk, d), np.float32)
    key[np.arange(nk), axis] = r.choice([-4.0, -1.0, 0.5, 2.0], size=nk)
    return key, r.normal(size=(nq, d)).astype(np.float32)


def _tied_everywhere(r, nk, nq, d):
    """The basis keys of ``_tied_keys`` and queries whose entries come from
    six dyadic values: exact norms, so scores also tie across directions."""
    key, _ = _tied_keys(r, nk, nq, d)
    query = r.choice([-2.0, -1.0, -0.5, 0.5, 1.0, 2.0], size=(nq, d)).astype(np.float32)
    return key, query


KEYSETS = {"random": _random_keys, "tied": _tied_keys, "tied_everywhere": _tied_everywhere}


def _loo_mask(r, nk):
    """A ragged leave-one-section-out mask: one random section held out."""
    cuts = np.sort(r.choice(np.arange(1, nk), size=3, replace=False))
    bounds = np.concatenate([[0], cuts, [nk]])
    held = int(r.integers(0, len(bounds) - 1))
    mask = np.ones(nk, bool)
    mask[bounds[held]:bounds[held + 1]] = False
    return mask


def test_topk_lowest_index_orders_ties_like_lax_top_k():
    scores = np.array([[1.0, 3.0, 3.0, 2.0, 3.0, 2.0],
                       [0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
                       [5.0, 4.0, 3.0, 2.0, 1.0, 0.0],
                       [-np.inf, 1.0, -np.inf, 1.0, -np.inf, 2.0]], np.float32)
    for k in range(1, 7):
        want_v, want_i = jax.lax.top_k(jnp.asarray(scores), k)
        got_v, got_i = retrieval.topk_lowest_index(torch.from_numpy(scores), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("keyset", sorted(KEYSETS))
@pytest.mark.parametrize("masked", [False, True])
def test_find_matches_indices_exact(keyset, masked):
    r = np.random.default_rng(len(keyset) * 10 + masked)
    key, query = KEYSETS[keyset](r, 150, 40, 8)
    mask = _loo_mask(r, 150) if masked else None
    for k in (1, 7, 23, int(mask.sum()) if masked else 150):
        jv, ji = jret.find_matches(jnp.asarray(key), jnp.asarray(query), k,
                                   key_mask=None if mask is None else jnp.asarray(mask))
        tv, ti = retrieval.find_matches(torch.from_numpy(key), torch.from_numpy(query), k,
                                        key_mask=None if mask is None else torch.from_numpy(mask))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji), err_msg=f"k={k}")
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("keyset", sorted(KEYSETS))
@pytest.mark.parametrize("chunk", [1, 7, 64, 4096])
def test_streaming_topk_indices_exact(keyset, chunk):
    """The streaming merge (running buffer before the chunk) selects what
    the JAX scan selects and what the dense path selects, pad chunk and
    masked keys included."""
    r = np.random.default_rng(100 + chunk)
    key, query = KEYSETS[keyset](r, 130, 17, 8)
    mask = _loo_mask(r, 130)
    k = 19
    _, ji = jret.streaming_topk(jnp.asarray(key), jnp.asarray(query), k, chunk_size=chunk,
                                key_mask=jnp.asarray(mask))
    _, ti = retrieval.streaming_topk(torch.from_numpy(key), torch.from_numpy(query), k,
                                     chunk_size=chunk, key_mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _, di = retrieval.find_matches(torch.from_numpy(key), torch.from_numpy(query), k,
                                   key_mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(ti.numpy(), di.numpy())


@pytest.mark.parametrize("trial", range(3))
def test_streaming_bf16_matches_jax_bf16(trial):
    r = np.random.default_rng(2000 + trial)
    key, query = _random_keys(r, 300, 12, 16)
    k, chunk = 9, [32, 128, 1024][trial]
    jv, ji = jret.streaming_topk(jnp.asarray(key), jnp.asarray(query), k, chunk_size=chunk,
                                 bf16=True)
    tv, ti = retrieval.streaming_topk(torch.from_numpy(key), torch.from_numpy(query), k,
                                      chunk_size=chunk, bf16=True)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("weight_ord", [1, 2, 0, -1])
@pytest.mark.parametrize("keyset", sorted(KEYSETS))
def test_retrieve_and_aggregate_matches_jax(weight_ord, keyset):
    """Every weighting, masked, with a K past the active count (clamped),
    chunked aggregation with a tail, dense and forced streaming."""
    r = np.random.default_rng(7 + weight_ord)
    key, query = KEYSETS[keyset](r, 120, 33, 8)
    expr = r.uniform(0.5, 3.0, size=(120, 5)).astype(np.float32)
    mask = _loo_mask(r, 120)
    for top_k, streaming in ((10, False), (10, True), (500, None)):
        kw = dict(top_k=top_k, weight_ord=weight_ord, chunk_size=8, streaming=streaming,
                  key_mask=mask)
        je, jx = jret.retrieve_and_aggregate(key, expr, query, **kw)
        te, tx = retrieval.retrieve_and_aggregate(key, expr, query, device="cpu", **kw)
        assert isinstance(tx, np.ndarray) and tx.shape == (33, 5)
        np.testing.assert_allclose(tx, jx, err_msg=f"k={top_k}", **PRED_TOL)
        np.testing.assert_allclose(te, je, err_msg=f"k={top_k}", **EMB_TOL)


def test_retrieve_and_aggregate_as_device_and_tensor_inputs():
    r = np.random.default_rng(3)
    key, query = _random_keys(r, 60, 9, 8)
    expr = r.uniform(0.5, 3.0, size=(60, 4)).astype(np.float32)
    _, want = jret.retrieve_and_aggregate(key, expr, query, top_k=6)
    te, tx = retrieval.retrieve_and_aggregate(torch.from_numpy(key), torch.from_numpy(expr),
                                              torch.from_numpy(query), top_k=6,
                                              as_device=True, device="cpu")
    assert isinstance(tx, torch.Tensor) and tx.device.type == "cpu"
    np.testing.assert_allclose(tx.numpy(), want, **PRED_TOL)


def test_streaming_switch_past_the_score_budget(monkeypatch):
    """streaming=None takes the streaming path past STREAMING_SCORE_ELEMENTS."""
    calls = []
    orig = retrieval.streaming_topk
    monkeypatch.setattr(retrieval, "streaming_topk",
                        lambda *a, **kw: calls.append(1) or orig(*a, **kw))
    r = np.random.default_rng(4)
    key, query = _random_keys(r, 40, 5, 4)
    expr = r.uniform(size=(40, 3)).astype(np.float32)
    retrieval.retrieve_and_aggregate(key, expr, query, top_k=3, device="cpu")
    assert calls == []
    monkeypatch.setattr(retrieval, "STREAMING_SCORE_ELEMENTS", 40 * 5 - 1)
    retrieval.retrieve_and_aggregate(key, expr, query, top_k=3, device="cpu")
    assert calls == [1]


def test_key_mask_rejects_an_empty_key_set():
    key = np.ones((4, 3), np.float32)
    with pytest.raises(ValueError, match="deactivates every"):
        retrieval.retrieve_and_aggregate(key, key, key, top_k=2, key_mask=np.zeros(4, bool),
                                         device="cpu")


def test_l2_normalize_matches_jax():
    x = np.random.default_rng(5).normal(size=(6, 7)).astype(np.float32)
    x[2] = 0.0  # the eps floor: a zero row stays zero
    np.testing.assert_allclose(retrieval.l2_normalize(torch.from_numpy(x)).numpy(),
                               np.asarray(jret.l2_normalize(jnp.asarray(x))),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("weight_ord", [1, 2, 0, -1])
def test_aggregate_from_selected_matches_jax(weight_ord):
    r = np.random.default_rng(11)
    sel_emb = r.normal(size=(5, 6, 8)).astype(np.float32)
    sel_expr = r.uniform(0.5, 3.0, size=(5, 6, 4)).astype(np.float32)
    q = r.normal(size=(5, 8)).astype(np.float32)
    je, jx = jret.aggregate_from_selected(jnp.asarray(sel_emb), jnp.asarray(sel_expr),
                                          jnp.asarray(q), weight_ord)
    te, tx = retrieval.aggregate_from_selected(torch.from_numpy(sel_emb),
                                               torch.from_numpy(sel_expr),
                                               torch.from_numpy(q), weight_ord)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **PRED_TOL)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), **EMB_TOL)
