"""Port parity of the real-dataset data layer: the port's readers, HVG panel,
``PosRemap`` and normalization against the JAX package on the same on-disk
trees, and the slice end to end (tree -> loaders -> ``train_fold``).

Every ``Section`` field must be equal: integer data and patches exactly,
expression within 1e-6 (both packages compute it in float64 from the same
counts and round to float32; the tolerance allows the last bit). The port
reads the tables with the standard library and binary PPM slides itself;
here, where PIL, OpenCV and pandas are installed, it opens the JAX trees'
JPEG and TIFF slides through them, as the JAX package does.
"""

import dataclasses
import gzip
import io
import os
import pickle
import sys
import warnings

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from mclstexp_tpu.config import Config as JaxConfig
from mclstexp_tpu.config import DataConfig as JaxDataConfig
from mclstexp_tpu.config import ModelConfig as JaxModelConfig
from mclstexp_tpu.config import TrainConfig as JaxTrainConfig
from mclstexp_tpu.data import genes as jax_genes
from mclstexp_tpu.data import hvg as jax_hvg
from mclstexp_tpu.data import normalize as jax_normalize
from mclstexp_tpu.data import panel as jax_panel
from mclstexp_tpu.data import st_dataset as jax_st
from mclstexp_tpu.data import synthetic as jax_synthetic
from mclstexp_tpu.data import visium as jax_visium
from mclstexp_tpu.data.posremap import PosRemap as JaxPosRemap
from mclstexp_tpu.data.section import Section as JaxSection
from mclstexp_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from mclstexp_tpu_torch.data import genes, hvg, io as port_io, normalize, panel, st_dataset
from mclstexp_tpu_torch.data import synthetic, visium
from mclstexp_tpu_torch.data.posremap import PosRemap
from mclstexp_tpu_torch.data.section import Section

torch.set_num_threads(1)

FIELDS = ("positions", "centers", "patches", "counts")


def _assert_sections_equal(ours, theirs):
    assert [s.name for s in ours] == [s.name for s in theirs]
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a.expression, b.expression, rtol=0, atol=1e-6)
        assert a.expression.dtype == b.expression.dtype == np.float32
        for f in FIELDS:
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None), f
            if x is not None:
                assert np.asarray(x).dtype == np.asarray(y).dtype, f
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=f)
        if b.labels is None:
            assert a.labels is None
        else:
            assert list(map(str, a.labels)) == list(map(str, np.asarray(b.labels, object)))


def _both_her2st(root, panel_genes, tmp_path, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # floor(NaN) -> int32
        theirs = jax_st.load_her2st(root, panel_genes,
                                    cache_dir=kw.pop("jax_cache", None), **kw)
        ours = st_dataset.load_her2st(root, panel_genes, device="cpu",
                                      cache_dir=str(tmp_path / "port_cache"), **kw)
    return ours, theirs


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_her2st_readers_match_jax(tmp_path, writer):
    """Trees written by JAX's write_st_layout (JPEG slides, read through
    PIL) and by the port's (PPM slides, read natively by the port)."""
    root = str(tmp_path / "tree")
    write = jax_synthetic.write_st_layout if writer == "jax" else synthetic.write_st_layout
    names, gene_names = write(root, num_sections=3, num_spots=14, num_genes=9, seed=2)
    panel_genes = gene_names[::-1][:6]
    ours, theirs = _both_her2st(root, panel_genes, tmp_path, patch_size=24)
    assert [s.name for s in ours] == names
    _assert_sections_equal(ours, theirs)
    assert ours[0].patches.shape == (14, 24, 24, 3)


def test_port_writer_matches_jax_writer(tmp_path):
    """Same seeds, same arrays: the tables byte for byte, the slides pixel
    for pixel before JAX's JPEG encoding (the port writes them losslessly)."""
    jroot, proot = str(tmp_path / "jax"), str(tmp_path / "port")
    assert (jax_synthetic.write_st_layout(jroot, 2, 10, 5, seed=3)
            == synthetic.write_st_layout(proot, 2, 10, 5, seed=3))
    for sub in ("ST-cnts/A1.tsv", "ST-cnts/B1.tsv", "ST-spotfiles/A1_selection.tsv"):
        with open(os.path.join(jroot, sub), "rb") as a, open(os.path.join(proot, sub), "rb") as b:
            assert a.read() == b.read(), sub
    rng = np.random.default_rng(3)
    for name in ("A1", "B1"):
        rng.poisson(3.0, size=(10, 5))
        want = rng.integers(0, 255, size=(300, 300, 3), dtype=np.uint8)  # (4 + 2) * 50
        np.testing.assert_array_equal(
            port_io.load_slide(os.path.join(proot, "ST-imgs", name[0], name, "slide.ppm")), want)


def test_duplicated_and_missing_spots(tmp_path):
    """A spot id listed twice expands to two rows (left join); a count row
    with no spot row gets NaN coordinates -> -2147483648 centers and
    positions, and an all-zero patch."""
    root = str(tmp_path / "tree")
    names, gene_names = synthetic.write_st_layout(root, num_sections=2, num_spots=9,
                                                  num_genes=6, seed=5)
    spot_file = os.path.join(root, "ST-spotfiles", f"{names[0]}_selection.tsv")
    with open(spot_file) as f:
        lines = f.read().splitlines()
    # row 2 twice (once with other pixel coords), row 5 dropped, x of row 3 at x.5
    dup = lines[2].split("\t")
    dup[2] = "333.7"
    lines = lines[:5] + lines[6:] + ["\t".join(dup)]
    with open(spot_file, "w") as f:
        f.write("\n".join(lines) + "\n")
    ours, theirs = _both_her2st(root, gene_names, tmp_path, patch_size=16)
    _assert_sections_equal(ours, theirs)
    s = ours[0]
    assert s.num_spots == 10  # 9 count rows, one expanded to two
    missing = (s.centers == -2**31).all(axis=1)
    assert missing.sum() == 1 and (s.positions[missing] == -2**31).all()
    assert not s.patches[missing].any()


def test_tsv_gz_cache_hit_and_size_mismatch_miss(tmp_path):
    root = str(tmp_path / "tree")
    names, gene_names = synthetic.write_st_layout(root, num_sections=2, num_spots=9,
                                                  num_genes=6, seed=1)
    port_io.gzip_in_place(st_dataset.her2st_cnt_path(root, names[0]))
    assert st_dataset.her2st_cnt_path(root, names[0]).endswith(".tsv.gz")
    cache = tmp_path / "cache"
    first = st_dataset.load_her2st(root, gene_names, patch_size=16, cache_dir=str(cache),
                                   device="cpu")
    hit = st_dataset.load_her2st(root, gene_names, patch_size=16, cache_dir=str(cache),
                                 device="cpu")
    assert all(isinstance(s.patches, np.memmap) for s in hit)
    _assert_sections_equal(hit, first)
    # the port's cache file is a hit for the JAX loader too, and equal
    _assert_sections_equal(hit, jax_st.load_her2st(root, gene_names, patch_size=16,
                                                   cache_dir=str(cache)))
    miss = st_dataset.load_her2st_section(root, names[0], gene_names, patch_size=8,
                                          cache_dir=str(cache), device="cpu")
    assert miss.patches.shape[1:3] == (8, 8) and not isinstance(miss.patches, np.memmap)
    assert np.load(cache / f"{names[0]}.npy", mmap_mode="r").shape[1:3] == (8, 8)
    np.testing.assert_array_equal(
        miss.patches, jax_st.load_her2st_section(root, names[0], gene_names, patch_size=8).patches)
    no_slide = st_dataset.load_her2st(root, gene_names, with_patches=False, device="cpu")
    assert all(s.patches is None for s in no_slide)


def test_her2st_section_names_slice_at_33(tmp_path):
    cnts = tmp_path / "ST-cnts"
    cnts.mkdir()
    all_names = [f"{c}{d}" for c in "ABCDEFGHIJK" for d in "123"][:33]
    for nm in all_names:
        (cnts / f"{nm}.tsv{'.gz' if nm[1] == '2' else ''}").touch()
    assert st_dataset.her2st_section_names(str(tmp_path)) == sorted(all_names)[1:33]
    assert st_dataset.her2st_section_names(str(tmp_path)) == jax_st.her2st_section_names(
        str(tmp_path))
    for f in sorted(cnts.iterdir())[3:]:
        f.unlink()
    assert st_dataset.her2st_section_names(str(tmp_path)) == ["A1", "A2", "A3"]


def test_her2st_labels_match_jax(tmp_path):
    root = tmp_path / "tree"
    names, gene_names = synthetic.write_st_layout(str(root), num_sections=1, num_spots=9,
                                                  num_genes=5, seed=7)
    lbl = root / "ST-pat" / "lbl"
    lbl.mkdir(parents=True)
    pos = pd.read_csv(root / "ST-spotfiles" / f"{names[0]}_selection.tsv", sep="\t")
    pos["x"] = pos["x"] + 0.2  # ids are rebuilt by rounding
    pos["label"] = ["invasive cancer", "", "breast glands", "NA", "immune infiltrate",
                    "undetermined", "cancer in situ", "connective tissue", "adipose tissue"]
    pos.to_csv(lbl / f"{names[0]}_labeled_coordinates.tsv", sep="\t", index=False)
    ours, theirs = _both_her2st(str(root), gene_names, tmp_path, patch_size=8,
                                with_labels=True)
    _assert_sections_equal(ours, theirs)
    assert ours[0].labels[0] == "invasive cancer"
    assert isinstance(ours[0].labels[1], float)  # an empty label reads as NaN


def _write_cscc(root, rng, name, n_genes=7):
    """A cSCC stdata TSV with two spots absent from the spot file, and a
    spot file with an extra spot and shuffled rows; a JPEG slide."""
    from PIL import Image

    ids = [f"{x}x{y}" for x in range(1, 5) for y in range(1, 4)]
    counts = pd.DataFrame(rng.poisson(4.0, size=(len(ids), n_genes)), index=ids,
                          columns=[f"G{i}" for i in range(n_genes)])
    with gzip.open(root / f"GSM_{name}_stdata.tsv.gz", "wt") as f:
        f.write(counts.to_csv(sep="\t"))
    xy = np.array([[x, y] for x in range(1, 5) for y in range(1, 4)][2:] + [[9, 9]], float)
    order = rng.permutation(len(xy))
    pd.DataFrame({"x": xy[order, 0], "y": xy[order, 1],
                  "pixel_x": xy[order, 0] * 40 + 3.7, "pixel_y": xy[order, 1] * 40 + 1.2}).to_csv(
        root / f"spot_data-selection-{name}.tsv", sep="\t", index=False)
    Image.fromarray(rng.integers(0, 255, size=(200, 220, 3), dtype=np.uint8)).save(
        root / f"GSM_{name}.jpg")
    return list(counts.columns)


def test_cscc_inner_join_matches_jax(tmp_path, rng):
    root = tmp_path / "cscc"
    root.mkdir()
    names = st_dataset.cscc_section_names()
    assert names == jax_st.cscc_section_names() and len(names) == 12
    gene_names = _write_cscc(root, rng, names[0])
    ours = st_dataset.load_cscc(str(root), gene_names[:4], names=names[:1], patch_size=16,
                                device="cpu")
    theirs = jax_st.load_cscc(str(root), gene_names[:4], names=names[:1], patch_size=16)
    _assert_sections_equal(ours, theirs)
    assert ours[0].num_spots == 10  # 12 count rows, 2 without a spot: dropped


def _write_10x_section(root, name, rng):
    synthetic.write_visium_layout(str(root), (name,), num_spots=15, num_genes=8, side=400,
                                  seed=int(rng.integers(1000)))
    return os.path.join(str(root), name)


@pytest.mark.parametrize("image", ["cv2_tif", "ppm"])
def test_visium_reader_matches_jax(tmp_path, rng, image):
    """BGR patches from a cv2-written TIFF (read through cv2 by both) and from
    a PPM (read natively by the port, through cv2 by JAX)."""
    import cv2

    data_root, prep = tmp_path / "visium", tmp_path / "prep"
    name = "block1"
    base = _write_10x_section(data_root, name, rng)
    if image == "cv2_tif":
        os.unlink(os.path.join(base, "image.tif"))
        cv2.imwrite(os.path.join(base, "image.tif"),
                    rng.integers(0, 255, size=(400, 400, 3), dtype=np.uint8))
    mdir = os.path.join(base, "filtered_feature_bc_matrix")
    _, _, gene_names = visium.read_10x_mtx(mdir)
    panel_genes = visium.make_var_names_unique(gene_names)[2:]
    visium.build_visium_preprocessed({name: mdir}, str(prep), panel_genes)
    ours = visium.load_visium(str(data_root), str(prep), (name,), patch_size=32,
                              cache_dir=str(tmp_path / "cache"), device="cpu")
    theirs = jax_visium.load_visium(str(data_root), str(prep), (name,), patch_size=32)
    _assert_sections_equal(ours, theirs)
    want_bgr = cv2.imread(os.path.join(base, "image.tif"))
    np.testing.assert_array_equal(visium.load_bgr(os.path.join(base, "image.tif")), want_bgr)
    assert ours[0].num_genes == len(panel_genes) and ours[0].counts is None


def test_visium_preprocessing_matches_jax_bytes(tmp_path, rng):
    """read_10x_mtx, make_var_names_unique and the preprocessed matrix file,
    byte for byte (a duplicated gene name included)."""
    base = _write_10x_section(tmp_path / "v", "CID4290", rng)
    mdir = os.path.join(base, "filtered_count_matrix")
    ours, theirs = visium.read_10x_mtx(mdir), jax_visium.read_10x_mtx(mdir)
    np.testing.assert_array_equal(ours[0], theirs[0])
    assert ours[1:] == theirs[1:] and ours[2][-1] == ours[2][0]
    names = ["A", "B", "A", "A", "B"]
    assert visium.make_var_names_unique(names) == jax_visium.make_var_names_unique(names)
    panel_genes = visium.make_var_names_unique(ours[2])[::-2]
    visium.build_visium_preprocessed({"CID4290": mdir}, str(tmp_path / "p"), panel_genes)
    jax_visium.build_visium_preprocessed({"CID4290": mdir}, str(tmp_path / "j"), panel_genes)
    with open(tmp_path / "p" / "CID4290" / "preprocessed_matrix.npy", "rb") as a, \
            open(tmp_path / "j" / "CID4290" / "preprocessed_matrix.npy", "rb") as b:
        assert a.read() == b.read()
    paths = visium.visium_section_paths("/d", "/p", "CID4290")
    assert paths == jax_visium.visium_section_paths("/d", "/p", "CID4290")
    assert visium.VISIUM_SECTIONS == jax_visium.VISIUM_SECTIONS


def _panel_frames(rng):
    frames = []
    for s in range(3):
        names = [f"g{i}" for i in range(30)] + (["only_in_1"] if s == 1 else [])
        counts = rng.poisson(5.0, size=(40, len(names))).astype(np.float32)
        for g in (0, 1, 2, 3) + ((5,) if s == 0 else ()):
            counts[:, g] = rng.poisson(1.0, 40) * rng.integers(0, 60, 40)
        frames.append((f"sec{s}", names, counts))
    return ([panel.CountFrame(*f) for f in frames], [jax_panel.CountFrame(*f) for f in frames])


@pytest.mark.parametrize("kw", [{}, {"min_sections": 2}, {"panel_size": 4}])
def test_select_panel_matches_jax(rng, kw):
    ours, theirs = _panel_frames(rng)
    assert panel.shared_gene_order(ours) == jax_panel.shared_gene_order(theirs)
    a = panel.select_panel(ours, n_top_genes=8, **kw)
    b = jax_panel.select_panel(theirs, n_top_genes=8, **kw)
    for f in dataclasses.fields(b):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(y, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


def test_panel_artifacts_cross_load(rng, tmp_path, monkeypatch):
    """Each package loads the other's panel; the pickles are pandas Series
    where pandas imports and the plain arrays where it does not."""
    ours, theirs = _panel_frames(rng)
    sel, jsel = panel.select_panel(ours, 8), jax_panel.select_panel(theirs, 8)
    path = panel.save_panel_artifacts(sel, str(tmp_path / "port"), "newds")
    jpath = jax_panel.save_panel_artifacts(jsel, str(tmp_path / "jax"), "newds")
    assert jax_genes.load_panel("newds", path) == genes.load_panel("newds", jpath) == sel.panel
    for fname in ("hvgs_union.pickle", "hvgs_intersection.pickle"):
        with open(tmp_path / "port" / fname, "rb") as a, open(tmp_path / "jax" / fname, "rb") as b:
            pd.testing.assert_series_equal(pickle.load(a), pickle.load(b))
    a = np.load(tmp_path / "port" / "per_section_hvg.npz", allow_pickle=True)
    b = np.load(tmp_path / "jax" / "per_section_hvg.npz", allow_pickle=True)
    for k in b.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)

    monkeypatch.setitem(sys.modules, "pandas", None)  # a machine without pandas
    panel.save_panel_artifacts(sel, str(tmp_path / "nopd"), "newds")
    with open(tmp_path / "nopd" / "hvgs_union.pickle", "rb") as f:
        union = pickle.load(f)
    assert isinstance(union, np.ndarray)
    np.testing.assert_array_equal(union, sel.union)


def test_load_panel_paths(tmp_path, monkeypatch):
    names = np.asarray(["GA", "GB", "GC"], dtype=object)
    np.save(tmp_path / "her_hvg_cut_1000.npy", names, allow_pickle=True)
    with open(tmp_path / "1000hvg_common.pkl", "wb") as f:
        pickle.dump(pd.Series(list(names)), f)
    monkeypatch.delenv("MCLSTEXP_REFERENCE_DATA", raising=False)
    from mclstexp_tpu_torch.config import reference_data_root

    assert reference_data_root() is None
    with pytest.raises(FileNotFoundError, match="MCLSTEXP_REFERENCE_DATA"):
        genes.load_panel("her2st")
    monkeypatch.setenv("MCLSTEXP_REFERENCE_DATA", str(tmp_path))
    assert reference_data_root() == str(tmp_path)
    for ds in ("her2st", "visium"):
        assert genes.load_panel(ds) == jax_genes.load_panel(ds) == ["GA", "GB", "GC"]
    assert genes.PANEL_SIZES == jax_genes.PANEL_SIZES


def test_count_frames_match_jax(tmp_path, rng):
    root = str(tmp_path / "tree")
    synthetic.write_st_layout(root, num_sections=3, num_spots=12, num_genes=20, seed=4)
    port_io.gzip_in_place(st_dataset.her2st_cnt_path(root, "B1"))
    for a, b in zip(panel.count_frames_for_dataset("her2st", root),
                    jax_panel.count_frames_for_dataset("her2st", root)):
        assert (a.name, a.genes) == (b.name, b.genes)
        np.testing.assert_array_equal(a.counts, b.counts)
        assert a.counts.dtype == b.counts.dtype
    croot = tmp_path / "cscc"
    croot.mkdir()
    for name in st_dataset.cscc_section_names():
        _write_cscc(croot, rng, name)
    for a, b in zip(panel.cscc_count_frames(str(croot)), jax_panel.cscc_count_frames(str(croot))):
        assert (a.name, a.genes) == (b.name, b.genes)
        np.testing.assert_array_equal(a.counts, b.counts)
    with pytest.raises(ValueError, match="visium"):
        panel.count_frames_for_dataset("visium", root)


@pytest.mark.parametrize("text,kw", [
    ("\tA\tB\tA\t\nr1\t1\t2\t3\t4\nr2\t5\tNA\t\t8\n", {"index_col": 0}),  # dups, Unnamed, NA
    ("A\tB\nr1\t1\t2\nr2\t3\t4\n", {}),  # a row one longer than the header: implicit index
    ("x\ty\tlabel\n1.5\t2.5\tfoo\n2.5\t-0.5\t\n3\t4\n", {}),  # short row, empty label
    ('a,"b,c",d\n1,"2,5",3\n', {"sep": ","}),  # quoting
])
def test_read_table_matches_pandas(tmp_path, text, kw):
    path = tmp_path / "t.tsv"
    path.write_text(text)
    want = pd.read_csv(io.StringIO(text), sep=kw.get("sep", "\t"), index_col=kw.get("index_col"))
    got = port_io.read_table(str(path), **kw)
    assert got.columns == [str(c) for c in want.columns]
    if got.index is not None:
        assert got.index == [str(i) for i in want.index]
    for j, c in enumerate(want.columns):
        col = want[c]
        if pd.api.types.is_numeric_dtype(col):
            np.testing.assert_array_equal(got.numeric([got.columns[j]])[:, 0],
                                          col.to_numpy(np.float64))
        else:
            assert list(map(str, got.strings(got.columns[j]))) == list(
                map(str, np.asarray(col, dtype=object)))


def test_load_slide_without_pil(tmp_path, monkeypatch):
    """PPM needs nothing; any other format names the missing package."""
    from PIL import Image

    img = np.random.default_rng(0).integers(0, 256, size=(7, 9, 3), dtype=np.uint8)
    port_io.write_ppm(str(tmp_path / "s.jpg"), img)  # detected by content, not name
    Image.fromarray(img).save(tmp_path / "s.png")
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "cv2", None)
    np.testing.assert_array_equal(port_io.load_slide(str(tmp_path / "s.jpg")), img)
    np.testing.assert_array_equal(visium.load_bgr(str(tmp_path / "s.jpg")), img[..., ::-1])
    with pytest.raises(ImportError, match="PIL"):
        port_io.load_slide(str(tmp_path / "s.png"))
    with pytest.raises(ImportError, match="cv2"):
        visium.load_bgr(str(tmp_path / "s.png"))


def test_ppm_with_comment_and_maxval_is_read_as_pil_reads_it(tmp_path):
    from PIL import Image

    img = np.random.default_rng(1).integers(0, 256, size=(5, 6, 3), dtype=np.uint8)
    path = tmp_path / "c.ppm"
    path.write_bytes(b"P6\n# a comment\n6 5\n255\n" + img.tobytes())
    np.testing.assert_array_equal(port_io.read_ppm(str(path)), img)
    np.testing.assert_array_equal(port_io.load_slide(str(path)),
                                  np.asarray(Image.open(path).convert("RGB")))
    path.write_bytes(b"P5\n6 5\n255\n" + img[..., 0].tobytes())  # greyscale: not native
    assert port_io.read_ppm(str(path)) is None
    np.testing.assert_array_equal(port_io.load_slide(str(path)),
                                  np.asarray(Image.open(path).convert("RGB")))


def _remap_sections(rng):
    out = []
    for i in range(3):
        pos = rng.integers(100, 4000, size=(20, 2)).astype(np.int32)
        out.append((f"v{i}", np.zeros((20, 3), np.float32), pos, pos[:, ::-1].copy()))
    return [Section(*s) for s in out], [JaxSection(*s) for s in out]


def test_posremap_matches_jax_and_cross_loads(rng, tmp_path):
    ours, theirs = _remap_sections(rng)
    a, b = PosRemap.build(ours), JaxPosRemap.build(theirs)
    np.testing.assert_array_equal(a.x_values, b.x_values)
    np.testing.assert_array_equal(a.y_values, b.y_values)
    assert a.vocab == b.vocab
    for x, y in zip(a.apply_sections(ours), b.apply_sections(theirs)):
        np.testing.assert_array_equal(x.positions, y.positions)
        assert x.positions.dtype == y.positions.dtype == np.int32
    full = rng.normal(size=(5000, 4)).astype(np.float32)
    np.testing.assert_array_equal(a.slice_x(full), b.slice_x(full))
    np.testing.assert_array_equal(a.scatter_y(a.slice_y(full), 5000),
                                  b.scatter_y(b.slice_y(full), 5000))
    a.save(str(tmp_path / "port.npz"))
    b.save(str(tmp_path / "jax.npz"))
    for got, want in ((JaxPosRemap.load(str(tmp_path / "port.npz")), a),
                      (PosRemap.load(str(tmp_path / "jax.npz")), b)):
        np.testing.assert_array_equal(got.x_values, want.x_values)
        np.testing.assert_array_equal(got.y_values, want.y_values)
        assert got.vocab == want.vocab
    with pytest.raises(ValueError, match="unseen x"):
        a.apply(np.array([[1, int(a.y_values[0])]]))


def test_normalize_and_hvg_match_jax(rng):
    counts = rng.poisson(5.0, size=(30, 40)).astype(np.float64)
    counts[3] = 0
    for rescale in (None, "median", "mean", 10000.0, 3):
        np.testing.assert_array_equal(normalize.library_size_normalize(counts, rescale),
                                      jax_normalize.library_size_normalize(counts, rescale))
    for target in (None, 1e4):
        np.testing.assert_array_equal(normalize.normalize_total(counts, target),
                                      jax_normalize.normalize_total(counts, target))
    logged = normalize.log1p(normalize.normalize_total(counts))
    np.testing.assert_array_equal(logged, jax_normalize.log1p(
        jax_normalize.normalize_total(counts)))
    for got, want in zip(hvg.seurat_dispersion(logged), jax_hvg.seurat_dispersion(logged)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(hvg.highly_variable_genes(logged, 7),
                                  jax_hvg.highly_variable_genes(logged, 7))
    masks = rng.uniform(size=(3, 40)) < 0.3
    for got, want in zip(hvg.hvg_union_intersection(masks),
                         jax_hvg.hvg_union_intersection(masks)):
        np.testing.assert_array_equal(got, want)
    pos = np.zeros((30, 2), np.int32)
    c32 = counts.astype(np.float32)
    np.testing.assert_array_equal(Section("s", c32, pos, pos, counts=c32).size_factors,
                                  JaxSection("s", c32, pos, pos, counts=c32).size_factors)
    assert Section("s", c32, pos, pos).size_factors is None


# ------------------------------------------------------------- the slice --

TINY = dict(encoder_name="tiny_densenet", image_dim=16, projection_dim=32, heads_num=2,
            heads_dim=16, pos_vocab=64, dense_block_impl="concat")
LR = 1e-3


def test_slice_tree_to_train_fold_matches_jax(tmp_path, monkeypatch):
    """A HER2ST tree -> count frames -> panel -> the port's loaders ->
    ``train_fold`` (tiny_densenet, weights from the JAX init through
    ``params_from_jax``, the JAX step's augmentation draws), against the JAX
    loaders -> JAX ``train_fold``: the same sections, and every step's loss
    within rtol 1e-4 (the 3-step parity's tolerance, test_torch_port_train.py)."""
    from mclstexp_tpu.parallel.mesh import make_mesh
    from mclstexp_tpu.train import loop as jax_loop
    from mclstexp_tpu.utils.logging import MetricLogger as JaxLogger
    from mclstexp_tpu_torch.interop import params_from_jax
    from mclstexp_tpu_torch.models.mclstexp import MclSTExp
    from mclstexp_tpu_torch.ops import augment
    from mclstexp_tpu_torch.train import loop
    from mclstexp_tpu_torch.train.state import TrainState, torch_adam
    from mclstexp_tpu_torch.utils.logging import MetricLogger
    from test_torch_port_augment import _jax_st_draws, _shears_agree

    root = str(tmp_path / "tree")
    synthetic.write_st_layout(root, num_sections=3, num_spots=12, num_genes=30, seed=6)
    frames = panel.her2st_count_frames(root)
    panel_genes = panel.select_panel(frames, n_top_genes=12, panel_size=10).panel
    assert panel_genes == jax_panel.select_panel(
        jax_panel.her2st_count_frames(root), n_top_genes=12, panel_size=10).panel
    ours = st_dataset.load_her2st(root, panel_genes, patch_size=16, device="cpu")
    theirs = jax_st.load_her2st(root, panel_genes, patch_size=16)
    _assert_sections_equal(ours, theirs)

    model_kw = {**TINY, "spot_dim": len(panel_genes)}
    train_kw = dict(batch_size=8, max_epochs=1, lr=LR, log_every=1, checkpoint_every_epochs=0,
                    seed=3)
    jcfg = JaxConfig(model=JaxModelConfig(**model_kw),
                     train=JaxTrainConfig(**train_kw, checkpoint_dir=str(tmp_path / "jax")),
                     data=JaxDataConfig(dataset="her2st", patch_size=16))
    cfg = Config(model=ModelConfig(**model_kw),
                 train=TrainConfig(**train_kw, checkpoint_dir=str(tmp_path / "port")),
                 data=DataConfig(dataset="her2st", patch_size=16))

    created = []
    jax_create = jax_loop.create_train_state

    def capture(*args, **kw):
        model, state = jax_create(*args, **kw)
        created.append(jax.device_get(state))  # a host copy: training donates the buffers
        return model, state

    monkeypatch.setattr(jax_loop, "create_train_state", capture)
    jlog = JaxLogger(echo=False)
    jax_loop.train_fold(jcfg, theirs, 1, logger=jlog, mesh=make_mesh((1,)))
    init = created[0]

    def shared_state(model_cfg, train_cfg, device):
        model = MclSTExp(model_cfg, device=device)
        model.load_state_dict(params_from_jax(init.params, init.batch_stats, model_cfg),
                              strict=True)
        return TrainState(model, torch_adam(model.parameters(), train_cfg.lr,
                                            train_cfg.weight_decay))

    def jax_draws(key, b, device):
        base, epoch, step = key
        rng = jax.random.fold_in(jax.random.PRNGKey(base), epoch * 100000 + step)
        draws = _jax_st_draws(jax.random.split(rng)[0], b)
        assert _shears_agree(draws.angles.numpy())
        return draws

    monkeypatch.setattr(loop, "create_train_state", shared_state)
    monkeypatch.setattr(augment, "reseed", lambda generator, *key: key)
    monkeypatch.setattr(augment, "sample_st_draws", jax_draws)
    log = MetricLogger(echo=False)
    loop.train_fold(cfg, ours, 1, logger=log, device="cpu")

    def losses(records):
        return [(r["epoch"], r["step"], r["loss"]) for r in records if "loss" in r]

    got, want = losses(log.records), losses(jlog.records)
    assert len(got) == len(want) == 3  # 24 training spots, batches of 8
    for (e, i, a), (je, ji, b) in zip(got, want):
        assert (e, i) == (je, ji)
        np.testing.assert_allclose(a, b, rtol=1e-4, err_msg=f"step {i}")
