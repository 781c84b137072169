"""The port's IvYGAP / TCGA readers (``sml_tpu_torch/data/datasets.py``, read
with ``csv`` and the port's HDF5 reader) against the JAX package's (pandas and
h5py): splits, ``x_path``, labels and gene vectors on the JAX tests' corpus
and on a harder one, the ``Loader`` over ``both``, and both readers over raw
patch JPEGs (``if_end2end``) against JAX's PIL-decoded bags."""

import csv
import os
import shutil
import sys

import h5py
import numpy as np
import pandas as pd
import pytest
import torch

from sml_tpu.config import Config as JConfig
from sml_tpu.data import datasets as jdatasets
from sml_tpu.data.loader import Loader as JLoader
from sml_tpu.data.loader import build_datasets as j_build_datasets
from sml_tpu_torch.config import Config
from sml_tpu_torch.data import datasets
from sml_tpu_torch.data.loader import Loader, build_datasets

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_data import _write_fake_corpus  # noqa: E402
from test_torch_raw_reader import write_slide  # noqa: E402

FIXDIM = 8
SIG_TUMOR = ["G4", "G0", "G9", "G2", "G7"]
SIG_IMMUNE = ["G1", "G11", "G3", "G5", "G8", "G10", "NA"]   # "NA" is read as NaN
TABLE_GENES = [f"G{i}" for i in range(12)]


def _write(path, rows, delimiter=",", comment=""):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", newline="") as f:
        f.write(comment)
        csv.writer(f, delimiter=delimiter, lineterminator="\n").writerows(rows)


def _features(path, rng):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with h5py.File(path, "w") as h:
        h.create_dataset("Res_feature",
                         data=rng.normal(size=(1, FIXDIM, 1024)).astype(np.float32))


def _write_hard_corpus(root, n_patients=14):
    """cdkn in {-2, -1, 0, NA}; numeric gene directory and file names; GDC
    rows without a gene name (NaN, matched by the signature's NA symbol),
    duplicate gene names; the signature in its own order; a patient with two
    slides; an all-integer fpkm well; gene values written with 17 digits; and
    the last IvYGAP slide's specimen missing from the gene table."""
    rng = np.random.default_rng(1)
    tcga, ivy = f"{root}/TCGA", f"{root}/IvYGAP"
    _write(f"{tcga}/gene_signature_selected.csv",
           [["gene_symbol", "Type"]] + [[g, "Tumor"] for g in SIG_TUMOR]
           + [[g, "Immune"] for g in SIG_IMMUNE] + [["G6", "Stromal"]])
    cdkns = [-2, -1, 0, "NA"]
    grades = ["G2", "G3", "G4"]

    rows = [["patient", "slide", "his", "grade", "idh", "codel", "cdkn", "c7", "c8",
             "c9", "c10", "gene_dir", "gene_file", "dead", "time"]]
    for i in range(n_patients):
        slides = [f"T{i}-01"] + ([f"T{i}-02"] if i == 3 else [])
        for s, slide in enumerate(slides):
            _features(f"{tcga}/Res50_feature_{FIXDIM}_fixdim0_norm/{slide}.h5", rng)
            gene_dir, gene_file = 100 + i, 50000 + 10 * i + s
            body = [["gene_id", "gene_name", "gene_type", "fpkm_uq_unstranded"]]
            body += [[f"N_{k}", "", "", ""] for k in ("unmapped", "multimapping")]
            order = rng.permutation(len(TABLE_GENES))
            for j in order:
                body.append([f"ENSG{j}", TABLE_GENES[j], "protein_coding",
                             repr(float(rng.uniform(0, 100)))])
            body.insert(5, [f"ENSG{order[0]}_PAR_Y", TABLE_GENES[order[0]], "dup",
                            repr(float(rng.uniform(0, 100)))])   # a later duplicate
            _write(f"{tcga}/transcriptomeProfiling_geneExpression/{gene_dir}/{gene_file}",
                   body, delimiter="\t", comment="# gene-model: GENCODE v36\n")
            idh = "WT" if i % 3 == 0 else "Mutant"
            rows.append([f"TP{i}", slide, ["astrocytoma", "glioblastoma", "oligodendroglioma",
                                           "oligoastrocytoma"][i % 4],
                         grades[i % 3], idh, "codel" if i % 4 == 1 else "non-codel",
                         cdkns[i % 4], 0, 0, 0, 0, gene_dir, gene_file, i % 2,
                         f"{40.0 + 97.3 * i:.1f}"])
    _write(f"{tcga}/multimodal_diag_survival_TCGA.csv", rows)

    gdir = f"{ivy}/gene_expression_matrix_2014-11-25"
    ids = [7000 + j for j in range(len(TABLE_GENES) + 1)]
    symbols = TABLE_GENES + ["NA"]
    _write(f"{gdir}/rows-genes.csv", [["gene_id", "gene_symbol", "entrez_id"]]
           + [[g, s, 90 + k] for k, (g, s) in enumerate(zip(ids, symbols))])
    wells = [2000 + i for i in range(n_patients)]
    _write(f"{gdir}/columns-samples.csv", [["rna_well_id", "specimen_name"]]
           + [[w, f"V{i}-1-1-X"] for i, w in enumerate(wells[:-1])])
    fpkm = [["gene_id\\rna_well_id"] + [str(w) for w in wells]]
    for g in rng.permutation(ids):
        fpkm.append([g] + [str(int(rng.integers(0, 9))) if k == 2
                           else repr(float(rng.uniform(0, 100))) for k in range(len(wells))])
    _write(f"{gdir}/fpkm_table.csv", fpkm)
    rows = [["patient", "slide", "c2", "grade", "idh", "codel", "cdkn", "dead", "time"]]
    for i in range(n_patients):
        slide = f"V{i}-1-1-D.01"
        _features(f"{ivy}/Res50_feature_{FIXDIM}_fixdim0_norm/{slide}.h5", rng)
        rows.append([f"VP{i}", slide, 0, grades[(i + 1) % 3],
                     "WT" if i % 2 else "Mutant", "codel" if i % 5 == 0 else "non-codel",
                     cdkns[(i + 2) % 4], (i + 1) % 2, f"{150.0 + 61.7 * i:.1f}"])
    _write(f"{ivy}/multimodal_diag_survival_IvY.csv", rows)


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    simple = str(tmp_path_factory.mktemp("simple"))
    _write_fake_corpus(simple, fixdim=FIXDIM, n_patients=10)
    hard = str(tmp_path_factory.mktemp("hard"))
    _write_hard_corpus(hard)
    return {"simple": simple + "/", "hard": hard + "/"}


def _pandas_vs_python_floats(root):
    """{(python f32, pandas f32)} of the table cells whose f32 values differ
    between pandas' default C float parser and Python's ``float``."""
    pairs = set()
    for dirpath, _, files in os.walk(root):
        for name in files:
            if not name.endswith(".csv") and "Expression" not in dirpath:
                continue
            path = os.path.join(dirpath, name)
            sep, skip = ("\t", 1) if "Expression" in dirpath else (",", 0)
            frame = pd.read_csv(path, sep=sep, skiprows=skip, header=0, dtype=str,
                                keep_default_na=False)
            parsed = pd.read_csv(path, sep=sep, skiprows=skip, header=0)
            for col in parsed.columns:
                if parsed[col].dtype != np.float64:
                    continue
                for s, v in zip(frame[col], parsed[col]):
                    if s in datasets.NA_STRINGS:
                        continue
                    a, b = np.float32(float(s)), np.float32(v)
                    if a != b:
                        pairs.add((float(a), float(b)))
    return pairs


def _same_sample(got, want, ulp_pairs, where):
    assert got.keys() == want.keys(), where
    for k in ("x_path", "labels"):
        assert got[k].dtype == want[k].dtype, (where, k)
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{where} {k}")
    for k in ("x_omic", "x_omic_tumor", "x_omic_immune"):
        g, w = got[k], want[k]
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape, (where, k)
        diff = ~((g == w) | (np.isnan(g) & np.isnan(w)))
        for a, b in zip(g[diff], w[diff]):
            # only where pandas' parser rounds a cell otherwise than float()
            assert (float(a), float(b)) in ulp_pairs, (where, k, a, b)
            assert abs(np.float32(a) - np.float32(b)) <= np.spacing(np.float32(b)), (a, b)


def _parts(ds):
    return ds.datasets if hasattr(ds, "datasets") else [ds]


@pytest.mark.parametrize("interval", ["all", "uncensored"])
@pytest.mark.parametrize("novalset", [False, True])
@pytest.mark.parametrize("dataset", ["IvYGAP", "TCGA", "both"])
@pytest.mark.parametrize("corpus", ["simple", "hard"])
def test_readers_match_jax(corpus, dataset, novalset, interval, corpora):
    kw = dict(dataset=dataset, dataDir=corpora[corpus], fixdim=FIXDIM, seed=5,
              novalset=novalset, survival_interval=interval)
    ulp_pairs = _pandas_vs_python_floats(corpora[corpus])
    for phase in ("Train", "Val", "Test"):
        want = j_build_datasets(JConfig(**kw), phase)
        got = build_datasets(Config(**kw), phase)
        assert len(got) == len(want), phase
        if novalset and phase == "Val":
            assert len(got) == 0
        for g, w in zip(_parts(got), _parts(want)):
            assert len(g.rows) == len(w.rows)
            assert set(g.rows[:, 0]) == set(w.rows[:, 0]) if len(w.rows) else True
            assert g.quantiles == w.quantiles
        for i in range(len(want)):
            try:
                w = want[i]
            except KeyError:
                with pytest.raises(KeyError, match="not in IvYGAP gene table"):
                    got[i]
                continue
            _same_sample(got[i], w, ulp_pairs, (phase, i))


def test_hard_corpus_traps_hold(corpora):
    """The harder corpus reaches each trap: a CDKN label from -2 / -1, both
    NaN-symbol rows, the duplicate dropped, an integer fpkm well, and the
    missing specimen."""
    root = corpora["hard"]
    kw = dict(dataset="TCGA", dataDir=root, fixdim=FIXDIM, seed=5)
    train = datasets.TCGADataset("Train", Config(**kw))
    samples = [train[i] for i in range(len(train))]
    assert {s["labels"][2] for s in samples} == {0.0, 1.0}
    # 12 named genes and the first of the GDC rows without a name
    assert all(len(s["x_omic"]) == 13 and np.isnan(s["x_omic"]).sum() == 1 for s in samples)
    assert all(len(s["x_omic_immune"]) == 7 for s in samples)
    ivy = datasets.IvYGAPDataset("Train", Config(**dict(kw, dataset="IvYGAP")))
    assert ivy.fpkm.columns["2002"][0] == "int"
    assert len(ivy.fpkm) == 13 and len(ivy.fpkm_tumor) + len(ivy.fpkm_immune) == 12
    missing = [i for i in range(len(ivy)) if ivy.rows[i][1].startswith("V13-")]
    jvy = jdatasets.IvYGAPDataset("Train", JConfig(**dict(kw, dataset="IvYGAP")))
    for ds in (ivy, jvy):
        for i in missing:
            with pytest.raises(KeyError):
                ds[i]


@pytest.mark.parametrize("epoch", [0, 1])
def test_loader_over_both_matches_jax(epoch, corpora):
    kw = dict(dataset="both", dataDir=corpora["simple"], fixdim=FIXDIM, seed=5)
    for phase, train in (("Train", True), ("Test", False)):
        args = dict(shuffle=True, drop_last=True, seed=5) if train else {}
        jl = JLoader(j_build_datasets(JConfig(**kw), phase), 3, **args)
        pl = Loader(build_datasets(Config(**kw), phase), 3, **args)
        jl.set_epoch(epoch)
        pl.set_epoch(epoch)
        want, got = list(jl), list(pl)
        assert len(got) == len(want) == len(pl) > 0
        for a, b in zip(got, want):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{phase} {k}")


@pytest.mark.parametrize("cells, kind", [
    (["3", " 4", "+5"], "int"), (["3", "", "4"], "float"), (["1e3", "NA"], "float"),
    (["0x10", "4"], "str"), (["NaN", "x"], "str"), (["1", "2.5"], "float"),
    (["inf", "-Infinity"], "float"), (["", ""], "float")])
def test_column_types_follow_pandas(cells, kind, tmp_path):
    path = tmp_path / "t.csv"
    path.write_text("a,b\n" + "".join(f"{c},x\n" for c in cells))
    want = pd.read_csv(path)["a"]
    got_kind, values = datasets.Table.read(str(path)).columns["a"]
    assert got_kind == kind
    assert want.dtype.kind == {"int": "i", "float": "f", "str": "O"}.get(
        kind, want.dtype.kind) or (kind == "str" and str(want.dtype) == "str")
    assert [v if v == v else "nan" for v in values] == \
        [v if v == v else "nan" for v in want.tolist()]


def test_signature_csv_is_required(tmp_path):
    os.makedirs(tmp_path / "TCGA")
    (tmp_path / "TCGA" / "gene_signature_selected.xlsx").write_bytes(b"")
    with pytest.raises(FileNotFoundError, match="gene_signature_selected.csv"):
        datasets._read_gene_signature(str(tmp_path))


def test_end2end_reader_is_not_ported(corpora, tmp_path):
    """``if_end2end=True``: both cohorts' readers over raw patch JPEGs (a
    ``wsi/`` tree and ``read_details`` beside the simple corpus, slides of 3
    patches, padded by repetition, and of 11, subsampled, to FIXDIM 8) give
    JAX's samples, ``x_path`` the (8, 224 * 224 * 3) bag as a CPU tensor."""
    root = str(tmp_path) + "/"
    shutil.copytree(corpora["simple"], root, dirs_exist_ok=True)
    for cohort, table in (("TCGA", "multimodal_diag_survival_TCGA.csv"),
                          ("IvYGAP", "multimodal_diag_survival_IvY.csv")):
        slides = pd.read_csv(os.path.join(root, cohort, table))["slide"]
        for k, slide in enumerate(slides):
            write_slide(os.path.join(root, cohort), os.path.join(root, cohort, "wsi"),
                        slide, 3 if k % 2 else 11, first=k)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for name in ("TCGADataset", "IvYGAPDataset"):
            cfg, jcfg = (C(dataset=name[:-7], dataDir=root, fixdim=FIXDIM, seed=5)
                         for C in (Config, JConfig))
            want = getattr(jdatasets, name)("Train", jcfg, if_end2end=True)
            got = getattr(datasets, name)("Train", cfg, if_end2end=True, device="cpu")
            assert len(got) == len(want) > 0
            for i in range(len(want)):
                g, w = got[i], want[i]
                assert isinstance(g["x_path"], torch.Tensor)
                g["x_path"] = g["x_path"].numpy()
                _same_sample(g, w, set(), (name, i))
    finally:
        torch.set_num_threads(threads)
