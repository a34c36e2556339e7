"""Analysis, domain clustering and the tutorial of the port against the JAX
package and scikit-learn, on the CPU.

Tolerances, each stated where used: ARI and NMI within 1e-12 of
scikit-learn's; PCA scores, signs included, within 1e-6 of
``PCA(svd_solver="full")`` in float64, and of ``PCA(random_state=0)`` for
each solver its "auto" rule picks within 1e-9 in float64 and 1e-3 of the
largest score in float32 (float32 rounding, which a flat spectrum's small
singular-value gaps amplify); k-means labels and k-means++ seeds exactly
scikit-learn's; ``cluster_predictions`` and ``gene_ranking`` equal to the
JAX package's (rounded scores, and the ranking's rows and values), on data
with structure (blobs, the tutorial's prediction) and on flat spectra at
her2st's width, where scikit-learn's randomized components are not the
exact ones.
"""

import numpy as np
import pytest
import torch
from sklearn.cluster import KMeans, kmeans_plusplus
from sklearn.datasets import make_blobs
from sklearn.decomposition import PCA
from sklearn.metrics import adjusted_rand_score, normalized_mutual_info_score

from mclstexp_tpu.infer import analysis as jax_analysis
from mclstexp_tpu.infer import metrics as jax_metrics
from mclstexp_tpu_torch import tutorial
from mclstexp_tpu_torch.infer import analysis, cluster, metrics

torch.set_num_threads(1)


@pytest.mark.parametrize("seed", range(8))
def test_scores_match_sklearn(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 300))
    a = rng.integers(0, int(rng.integers(1, 7)), size=n)
    b = rng.integers(0, int(rng.integers(1, 7)), size=n)
    if seed == 0:
        b = a.copy()  # full agreement
    if seed == 1:
        a = np.zeros(n, int)  # one cluster against several
    if seed == 2:
        a, b = np.zeros(n, int), np.ones(n, int)  # one cluster each
    labels = (a.astype(str), np.char.add("c", b.astype(str)))
    for x, y in ((a, b), labels):
        assert abs(cluster.adjusted_rand_score(x, y) - adjusted_rand_score(x, y)) <= 1e-12
        assert abs(cluster.normalized_mutual_info_score(x, y)
                   - normalized_mutual_info_score(x, y)) <= 1e-12


@pytest.mark.parametrize("n_components", [2, 5, 9])
def test_pca_matches_sklearn_full(n_components):
    x, _ = make_blobs(n_samples=240, n_features=40, centers=7, random_state=n_components)
    got = cluster.pca(x, n_components, device="cpu").numpy()
    want = PCA(n_components, svd_solver="full").fit_transform(x)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    got32 = cluster.pca(x.astype(np.float32), n_components, device="cpu")
    assert got32.dtype == torch.float32  # in the input's type, as scikit-learn
    want32 = PCA(n_components, svd_solver="full").fit_transform(x.astype(np.float32))
    np.testing.assert_allclose(got32.numpy(), want32, rtol=0,
                               atol=1e-3 * np.abs(want32).max())


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("shape, n_components, solver", [
    ((240, 40), 5, "full"),  # at most 500 along both sides
    ((600, 785), 500, "full"),  # components at 80% of the smaller side or more
    ((2000, 100), 9, "covariance_eigh"),  # ten times as many samples as features
    ((600, 785), 9, "randomized"),  # her2st's clustering: transposed, 7 iterations
    ((700, 300), 9, "randomized"),  # not transposed
    ((600, 785), 70, "randomized"),  # 4 power iterations
])
def test_pca_matches_sklearn_by_solver(shape, n_components, solver, dtype):
    """``PCA(n_components, random_state=0).fit_transform`` on a flat spectrum
    (unit noise), whichever solver scikit-learn's "auto" picks."""
    x = np.random.default_rng(shape[1] + n_components).normal(size=shape).astype(dtype)
    model = PCA(n_components, random_state=0)
    want = model.fit_transform(x)
    assert model._fit_svd_solver == cluster.pca_solver(shape, n_components) == solver
    got = cluster.pca(x, n_components, random_state=0, device="cpu")
    assert got.dtype == torch.from_numpy(want).dtype
    if dtype == np.float64:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-9)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3 * np.abs(want).max())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kmeans_matches_sklearn(seed):
    for std, features in ((1.0, 9), (3.0, 10)):  # separated, then overlapping blobs
        x, _ = make_blobs(n_samples=600, n_features=features, centers=6, cluster_std=std,
                          random_state=seed + 10)
        labels, centers = cluster.kmeans(x, 6, random_state=seed, device="cpu")
        km = KMeans(n_clusters=6, init="k-means++", random_state=seed).fit(x)
        np.testing.assert_array_equal(labels, km.labels_)
        np.testing.assert_allclose(centers, km.cluster_centers_, rtol=0, atol=1e-10)
        seeds, idx = cluster.kmeans_plusplus(x, 6, random_state=seed, device="cpu")
        want_seeds, want_idx = kmeans_plusplus(x, 6, random_state=seed)
        np.testing.assert_array_equal(idx, want_idx)
        np.testing.assert_array_equal(seeds, want_seeds)
    with pytest.raises(ValueError, match="n_clusters"):
        cluster.kmeans(x[:3], 6, device="cpu")


def test_kmeans_with_fewer_distinct_points_than_clusters():
    """Duplicated points leave a cluster empty: scikit-learn places it on the
    heaviest cluster (its relocation finds no distance to move it by)."""
    x = np.repeat(np.array([[0.0, 0.0], [5.0, 1.0], [-3.0, 4.0]]), [7, 5, 4], axis=0)
    labels, centers = cluster.kmeans(x, 4, random_state=0, device="cpu")
    with pytest.warns(Warning, match="distinct clusters"):
        km = KMeans(n_clusters=4, init="k-means++", random_state=0).fit(x)
    np.testing.assert_array_equal(labels, km.labels_)
    np.testing.assert_allclose(centers, km.cluster_centers_, rtol=0, atol=1e-12)


def test_cluster_predictions_match_jax_at_her2st_width():
    """600 spots x 785 genes, 6 domains and some "undetermined" spots."""
    x, y = make_blobs(n_samples=600, n_features=785, centers=6, cluster_std=4.0,
                      random_state=5)
    labels = np.array([f"domain{v}" for v in y], dtype=object)
    labels[::37] = "undetermined"
    got = metrics.cluster_predictions(x.astype(np.float32), labels, device="cpu")
    want = jax_metrics.cluster_predictions(x.astype(np.float32), labels)
    assert got == want and got["n_clusters"] == 6
    # scikit-learn's PCA is randomized at this width, and so is the port's
    pca = PCA(n_components=9, random_state=0).fit(x.astype(np.float32))
    assert pca._fit_svd_solver == cluster.pca_solver((560, 785), 9) == "randomized"


@pytest.mark.parametrize("scale", [0.0, 0.15, 0.3])
@pytest.mark.parametrize("seed", range(6))
def test_cluster_predictions_match_jax_on_flat_spectra(seed, scale):
    """600 spots x 785 genes of unit noise around six seed-made domain
    centers of ``scale`` (0: isotropic noise, no domain gap): the spectrum
    is flat, the randomized components are not the exact ones, and the
    port's scores must be JAX's all the same."""
    rs = np.random.RandomState(seed)
    y = rs.randint(0, 6, size=600)
    x = (scale * rs.normal(size=(6, 785))[y] + rs.normal(size=(600, 785))).astype(np.float32)
    labels = np.array([f"domain{v}" for v in y], dtype=object)
    got = metrics.cluster_predictions(x, labels, device="cpu")
    assert got == jax_metrics.cluster_predictions(x, labels) and got["n_clusters"] == 6


def _ranking_inputs():
    rng = np.random.default_rng(4)
    genes = [f"G{i}" for i in range(12)]
    preds, truths = [], []
    for n in (40, 55, 31):
        true = rng.normal(size=(n, 12))
        pred = true + rng.normal(scale=rng.uniform(0.2, 3.0, size=12), size=(n, 12))
        pred[:, 3] = 2.0 * true[:, 3] + 1.0  # r = 1: p = 0, -log10 p = 300 (a tie)
        pred[:, 7] = -true[:, 7]  # r = -1: 300 as well
        pred[:, 9] = 5.0  # constant prediction: NaN r and p in every section
        preds.append(pred)
        truths.append(true)
    preds[1][:, 5] = 1.0  # NaN in one section only: the nan-means skip it
    preds[2][:, 0] = 3.0 * truths[2][:, 0]  # a third tied gene, in one section
    return preds, truths, genes


def test_gene_ranking_matches_jax():
    preds, truths, genes = _ranking_inputs()
    names = ["A1", "B1", "C1"]
    got = analysis.gene_ranking(preds, truths, genes, names)
    want = jax_analysis.gene_ranking(preds, truths, genes, names).to_dict("list")
    assert list(got) == list(want) == list(analysis.RANKING_COLUMNS)
    assert got["gene"] == want["gene"] and got["best_section"] == want["best_section"]
    for col in ("mean_pcc", "mean_neglog10_p", "best_pcc"):
        np.testing.assert_array_equal(got[col], np.asarray(want[col], np.float64))
    assert got["gene"][-1] == "G9" and np.isnan(got["mean_pcc"][-1])  # NaN last
    assert sorted(got["gene"][:2]) == ["G3", "G7"]  # the tied 300s lead
    # default section names
    assert analysis.gene_ranking(preds[:1], truths[:1], genes)["best_section"][0] == "S0"
    text = analysis.format_ranking(got, 5).splitlines()
    assert len(text) == 6 and text[0].split() == list(analysis.RANKING_COLUMNS)
    assert text[1].split()[1] == got["gene"][0]


def test_plots_write_a_png(tmp_path):
    import matplotlib.pyplot as plt

    preds, truths, genes = _ranking_inputs()
    centers = np.random.default_rng(1).integers(0, 500, size=(40, 2))
    out = tmp_path / "G3.png"
    fig = analysis.compare_gene_plot(centers, preds[0], truths[0], genes, "G3", str(out))
    try:
        assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
        assert [ax.get_title() for ax in fig.axes[:2]] == ["G3 predicted (r=1.000)",
                                                           "G3 measured"]
        ax = analysis.spatial_plot(centers, truths[0][:, 0], "G0")
        assert ax.get_title() == "G0"
    finally:
        plt.close("all")


def test_tutorial_runs_and_its_analysis_matches_jax(tmp_path, capsys):
    """The port's tutorial end to end on the CPU (one epoch); its ranking and
    clustering equal the JAX package's analysis functions on its prediction."""
    out = tutorial.main(str(tmp_path), max_epochs=1, device="cpu")
    printed = capsys.readouterr().out
    for step in range(1, 6):
        assert f"== {step}. " in printed
    pred = out["pred"]
    sections_expr = np.load(tmp_path / "pred.npy").T
    np.testing.assert_array_equal(pred, sections_expr)
    assert pred.shape == (64, 32) and np.isfinite(pred).all()
    assert all(np.isfinite(v) for v in out["metrics"].values())
    from mclstexp_tpu_torch.data import synthetic

    truth = synthetic.make_dataset(num_sections=3, num_spots=64, num_genes=32,
                                   patch_size=24, seed=11)[0]
    genes = [f"GENE{i}" for i in range(32)]
    want = jax_analysis.gene_ranking([pred], [truth.expression], genes,
                                     [truth.name]).to_dict("list")
    assert out["ranking"]["gene"] == want["gene"]
    np.testing.assert_array_equal(out["ranking"]["mean_neglog10_p"], want["mean_neglog10_p"])
    assert out["png"] == str(tmp_path / f"{want['gene'][0]}.png")
    assert (tmp_path / f"{want['gene'][0]}.png").exists()
    assert out["clustering"] == jax_analysis.domain_clustering(pred, out["labels"])
    assert metrics.cluster_predictions(pred, out["labels"], device="cpu") == \
        jax_metrics.cluster_predictions(pred, out["labels"])
