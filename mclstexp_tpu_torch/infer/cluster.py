"""PCA, k-means and the two clustering scores of domain clustering.

The JAX package clusters predicted expression with scikit-learn
(``mclstexp_tpu/infer/metrics.py::cluster_predictions``: ``PCA``,
``KMeans(init="k-means++")``, ``adjusted_rand_score``,
``normalized_mutual_info_score``). The port has its own versions, so that
it needs no scikit-learn on the machine of the card:

* ``pca``: scikit-learn's ``PCA(n_components, random_state=...)
  .fit_transform`` with its default ``svd_solver="auto"``, which picks by
  the data's shape (``decomposition/_pca.py::_fit``): "covariance_eigh"
  (at most 1,000 features and at least ten times as many samples: the
  eigenvectors of the covariance matrix), "full" (at most 500 along both
  sides, or components at 80% of the smaller side or more: an exact SVD of
  the centered data), else "randomized" (``utils/extmath.py::
  _randomized_svd``: 10 oversamples, 7 power iterations under 10% of the
  smaller side else 4, each normalized by an LU factorization, the
  Gaussian test matrix drawn by ``np.random.RandomState(random_state)`` on
  the host, the shorter side's transpose as scikit-learn takes it). Each
  computes in the input's type (float32 stays float32, anything else is
  float64) on ``device``, then takes scikit-learn's sign rule
  (``svd_flip(u_based_decision=False)``: each component's largest entry
  positive). Her2st's clustering (600 spots x 785 genes, 9 components) is
  randomized; on a flat spectrum its components are not the exact ones,
  and the port computes the same approximation as scikit-learn.
* ``kmeans``: scikit-learn's ``KMeans(init="k-means++", n_init="auto")``,
  i.e. one k-means++ seeding and the Lloyd loop. The seeding's random draws
  come from ``np.random.RandomState(random_state)`` on the host in
  scikit-learn's order (the first center by ``choice``, then ``2 +
  int(log k)`` uniforms per center); the distances, the candidates' pick
  and the Lloyd loop run in float64 on ``device``. Convergence as
  scikit-learn's: labels unchanged, or the centers' squared shift within
  1e-4 of the mean column variance; empty clusters take the samples
  farthest from their centers.
* ``adjusted_rand_score`` and ``normalized_mutual_info_score`` (arithmetic
  mean of the entropies): scikit-learn's formulas over the contingency
  table, in integers and float64 on the host.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

MAX_ITER = 300
TOL = 1e-4


def _as_float64(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float64)
    return torch.as_tensor(np.asarray(x), dtype=torch.float64, device=device)


def pca_solver(shape: Tuple[int, int], n_components: int) -> str:
    """The solver scikit-learn's ``svd_solver="auto"`` picks for dense data
    of ``shape`` (samples, features)."""
    n, g = shape
    if g <= 1_000 and n >= 10 * g:
        return "covariance_eigh"
    if max(n, g) <= 500:
        return "full"
    if 1 <= n_components < 0.8 * min(n, g):
        return "randomized"
    return "full"


def _svd_flip(u: Optional[torch.Tensor], vt: torch.Tensor):
    """``svd_flip(u_based_decision=False)``: each row of ``vt`` signed so
    that its largest |entry| (the first where several tie) is positive, and
    the matching column of ``u`` with it."""
    rows = torch.arange(vt.shape[0], device=vt.device)
    signs = torch.sign(vt[rows, vt.abs().argmax(dim=1)])
    return (None if u is None else u * signs[None, :]), vt * signs[:, None]


def _randomized_svd(m: torch.Tensor, n_components: int,
                    random_state: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """scikit-learn's ``_randomized_svd(m, n_components, n_oversamples=10,
    n_iter="auto", power_iteration_normalizer="auto", flip_sign=False)``
    in ``m``'s type: (U (n, k), S (k,), Vt (k, g))."""
    n_random = n_components + 10
    n_iter = 7 if n_components < 0.1 * min(m.shape) else 4
    transpose = m.shape[0] < m.shape[1]
    if transpose:
        m = m.T
    # the test matrix, drawn on the host and cast while still numpy
    q = np.random.RandomState(random_state).normal(size=(m.shape[1], n_random))
    q = torch.as_tensor(q.astype(np.float32, copy=False) if m.dtype == torch.float32 else q,
                        device=m.device)

    def lu(a):  # scipy's lu(permute_l=True): P @ L; "none" at two iterations or fewer
        if n_iter <= 2:
            return a
        p, lower, _ = torch.linalg.lu(a)
        return p @ lower

    for _ in range(n_iter):
        q = lu(m @ q)
        q = lu(m.T @ q)
    q, _ = torch.linalg.qr(m @ q, mode="reduced")
    u_hat, s, vt = torch.linalg.svd(q.T @ m, full_matrices=False)
    u = q @ u_hat
    if transpose:
        return vt[:n_components].T, s[:n_components], u[:, :n_components].T
    return u[:, :n_components], s[:n_components], vt[:n_components]


def pca(x, n_components: int, random_state: int = 0, device="cuda") -> torch.Tensor:
    """``PCA(n_components, random_state=random_state).fit_transform(x)``:
    the first ``n_components`` principal-component scores of ``x`` (N, G),
    (N, n_components) on ``device``, by the solver ``pca_solver`` picks, in
    ``x``'s type (float32, else float64)."""
    device = torch.device(device)
    x = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x, device=device)
    if x.dtype != torch.float32:
        x = x.to(torch.float64)
    n = x.shape[0]
    mean = x.mean(dim=0)
    solver = pca_solver(tuple(x.shape), n_components)
    if solver == "covariance_eigh":
        cov = x.T @ x
        cov -= n * mean[:, None] * mean[None, :]
        cov /= n - 1
        _, vecs = torch.linalg.eigh(cov)  # ascending; the largest first after the flip
        _, vt = _svd_flip(None, vecs.flip(1).T[:n_components])
        return x @ vt.T - mean[None, :] @ vt.T
    xc = x - mean
    if solver == "full":
        u, s, vt = torch.linalg.svd(xc, full_matrices=False)
    else:
        u, s, vt = _randomized_svd(xc, n_components, random_state)
    u, _ = _svd_flip(u, vt)
    return u[:, :n_components] * s[:n_components]


def _sq_distances(c: torch.Tensor, c_sq: torch.Tensor, x: torch.Tensor,
                  x_sq: torch.Tensor) -> torch.Tensor:
    """scikit-learn's ``_euclidean_distances(squared=True)`` in float64:
    -2 c·x + |c|² + |x|², clipped at 0."""
    d = -2.0 * (c @ x.T)
    d += c_sq[:, None]
    d += x_sq[None, :]
    return d.clamp_min_(0.0)


def _seeding_draws(n_samples: int, n_clusters: int,
                  random_state: int) -> Tuple[int, np.ndarray]:
    """The host draws of one k-means++ seeding, in scikit-learn's order: the
    first center's index and a (n_clusters - 1, 2 + int(log k)) array of
    uniforms. With unit sample weights no draw depends on the data."""
    rs = np.random.RandomState(random_state)
    weights = np.ones(n_samples)
    first = int(rs.choice(n_samples, p=weights / weights.sum()))
    trials = 2 + int(np.log(n_clusters))
    uniforms = np.stack([rs.uniform(size=trials) for _ in range(n_clusters - 1)]) \
        if n_clusters > 1 else np.zeros((0, trials))
    return first, uniforms


def _kmeans_plusplus(x: torch.Tensor, x_sq: torch.Tensor, n_clusters: int,
                     random_state: int) -> Tuple[torch.Tensor, torch.Tensor]:
    first, uniforms = _seeding_draws(x.shape[0], n_clusters, random_state)
    indices = torch.empty(n_clusters, dtype=torch.int64, device=x.device)
    indices[0] = first
    closest = _sq_distances(x[first:first + 1], x_sq[first:first + 1], x, x_sq)[0]
    pot = closest.sum()
    draws = torch.as_tensor(uniforms, dtype=torch.float64, device=x.device)
    for c in range(1, n_clusters):
        cand = torch.searchsorted(torch.cumsum(closest, 0), draws[c - 1] * pot)
        cand = cand.clamp_max_(x.shape[0] - 1)
        dist = torch.minimum(closest[None, :], _sq_distances(x[cand], x_sq[cand], x, x_sq))
        pots = dist.sum(dim=1)
        best = torch.argmin(pots)
        pot, closest = pots[best], dist[best]
        indices[c] = cand[best]
    return x[indices], indices


def kmeans_plusplus(x, n_clusters: int, random_state: int = 0,
                    device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """scikit-learn's ``kmeans_plusplus(x, n_clusters, random_state=...)``:
    (centers (k, G) float64, indices (k,)) as host arrays."""
    x = _as_float64(x, torch.device(device))
    centers, indices = _kmeans_plusplus(x, (x * x).sum(dim=1), n_clusters, random_state)
    return centers.cpu().numpy(), indices.cpu().numpy()


def _relocate_empty(x, labels, centers_old, sums, weights) -> None:
    """scikit-learn's ``_relocate_empty_clusters_dense``: each empty cluster,
    in index order, takes the next of the samples farthest from their
    centers (picked on the host by the same ``argpartition``)."""
    empty = torch.nonzero(weights == 0).squeeze(1).tolist()
    dist = ((x - centers_old[labels]) ** 2).sum(dim=1).cpu().numpy()
    if dist.max() == 0:  # fewer distinct samples than clusters
        return
    far = np.argpartition(dist, -len(empty))[:-len(empty) - 1:-1]
    for new_id, idx in zip(empty, far.tolist()):
        old_id = int(labels[idx])
        sums[old_id] -= x[idx]
        sums[new_id] = x[idx]
        weights[new_id] = 1.0
        weights[old_id] -= 1.0


def _average(sums: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """scikit-learn's ``_average_centers``: a cluster left empty sits on the
    heaviest one (averaged already when it comes earlier in index order)."""
    out = sums / weights.clamp_min(1.0)[:, None]
    empty = torch.nonzero(weights <= 0).squeeze(1).tolist()
    if empty:
        heavy = int(torch.argmax(weights))
        for j in empty:
            out[j] = out[heavy] if heavy < j else sums[heavy]
    return out


def _assign(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """The closest center of each sample by |c|² - 2 x·c, the first of tied
    ones (scikit-learn's strict ``<`` over the clusters in order)."""
    c_sq = (centers * centers).sum(dim=1)
    return torch.addmm(c_sq.expand(x.shape[0], -1), x, centers.T, beta=1.0,
                       alpha=-2.0).argmin(dim=1)


def kmeans(x, n_clusters: int, random_state: int = 0,
           device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """scikit-learn's ``KMeans(n_clusters, init="k-means++",
    random_state=random_state).fit(x)``: (labels (N,) int64, centers (k, G)
    float64) as host arrays."""
    x = _as_float64(x, torch.device(device))
    n = x.shape[0]
    if n < n_clusters:
        raise ValueError(f"n_samples={n} should be >= n_clusters={n_clusters}.")
    tol = float(x.var(dim=0, unbiased=False).mean()) * TOL
    mean = x.mean(dim=0)
    x = x - mean  # scikit-learn centers before its distances
    centers, _ = _kmeans_plusplus(x, (x * x).sum(dim=1), n_clusters, random_state)
    ones = torch.ones(n, dtype=torch.float64, device=x.device)
    labels_old = torch.full((n,), -1, dtype=torch.int64, device=x.device)
    strict = False
    for _ in range(MAX_ITER):
        labels = _assign(x, centers)
        sums = torch.zeros_like(centers).index_add_(0, labels, x)
        weights = torch.zeros(n_clusters, dtype=torch.float64,
                              device=x.device).index_add_(0, labels, ones)
        if bool((weights == 0).any()):
            _relocate_empty(x, labels, centers, sums, weights)
        new = _average(sums, weights)
        shift = ((new - centers) ** 2).sum()
        centers = new
        same = torch.equal(labels, labels_old)
        if same:
            strict = True
            break
        if bool(shift <= tol):
            break
        labels_old = labels
    if not strict:
        labels = _assign(x, centers)  # the labels of the final centers
    return labels.cpu().numpy(), (centers + mean).cpu().numpy()


def _contingency(labels_true: Sequence, labels_pred: Sequence) -> np.ndarray:
    _, ti = np.unique(np.asarray(labels_true), return_inverse=True)
    _, pi = np.unique(np.asarray(labels_pred), return_inverse=True)
    table = np.zeros((ti.max(initial=-1) + 1, pi.max(initial=-1) + 1), dtype=np.int64)
    np.add.at(table, (ti.ravel(), pi.ravel()), 1)
    return table


def adjusted_rand_score(labels_true: Sequence, labels_pred: Sequence) -> float:
    """scikit-learn's ARI from the pair confusion matrix, in Python integers."""
    table = _contingency(labels_true, labels_pred)
    n = int(table.sum())
    n_c, n_k = table.sum(axis=1), table.sum(axis=0)
    sum_squares = int((table ** 2).sum())
    tp = sum_squares - n
    fp = int((table @ n_k).sum()) - sum_squares
    fn = int((table.T @ n_c).sum()) - sum_squares
    tn = n * n - fp - fn - sum_squares
    if fn == 0 and fp == 0:
        return 1.0
    return 2.0 * (tp * tn - fn * fp) / ((tp + fn) * (fn + tn) + (tp + fp) * (fp + tn))


def _entropy(labels: Sequence) -> float:
    labels = np.asarray(labels)
    if labels.shape[0] == 0:
        return 1.0
    pi = np.unique(labels, return_counts=True)[1].astype(np.float64)
    if pi.size == 1:
        return 0.0
    pi_sum = np.sum(pi)
    return float(-np.sum((pi / pi_sum) * (np.log(pi) - np.log(pi_sum))))


def normalized_mutual_info_score(labels_true: Sequence, labels_pred: Sequence) -> float:
    """scikit-learn's NMI with the arithmetic mean of the two entropies."""
    table = _contingency(labels_true, labels_pred)
    if table.shape[0] == table.shape[1] <= 1:  # neither labelling splits the data
        return 1.0
    if table.shape[0] == 1 or table.shape[1] == 1:
        return 0.0  # one side has zero entropy, so the mutual information is 0
    nzx, nzy = np.nonzero(table)
    nz = table[nzx, nzy].astype(np.float64)
    total = float(table.sum())
    pi, pj = table.sum(axis=1).astype(np.float64), table.sum(axis=0).astype(np.float64)
    outer = pi.take(nzx).astype(np.int64) * pj.take(nzy).astype(np.int64)
    log_outer = -np.log(outer) + np.log(pi.sum()) + np.log(pj.sum())
    p = nz / total
    mi = p * (np.log(nz) - np.log(total)) + p * log_outer
    mi = np.where(np.abs(mi) < np.finfo(mi.dtype).eps, 0.0, mi)
    mi = float(np.clip(mi.sum(), 0.0, None))
    if mi == 0:
        return 0.0
    return float(mi / np.mean([_entropy(labels_true), _entropy(labels_pred)]))
