"""IvYGAP and TCGA cohort readers (counterpart of ``sml_tpu/data/datasets.py``).

Sample contract: (x_path (fixdim, 1024) f32, x_omic (431,), x_omic_tumor (59,),
x_omic_immune (361,), labels (12,)); with ``if_end2end`` x_path is the raw
patch bag instead, a (fixdim, 224 * 224 * 3) f32 tensor on the reader's device
(``RawPatchReader``).  Splits are patient-level after a seeded
shuffle (0.8 / 0.1 / 0.1: Train first, then Test, Val last; 0.67 / 0.33 with
``novalset``).  WSI features come from per-slide HDF5 files
(``Res50_feature_{fixdim}_fixdim0_norm/{id}.h5``, dataset ``Res_feature``),
read by the port's own reader (``data/h5.py``); survival bins use the fixed
TCGA + IvYGAP quantiles.

The tables are read with the standard ``csv`` module, each column typed as
``pandas.read_csv`` types it by default, since the labels depend on it
(``cdkn in (-2, -1)``, ``dead == 1``, ``str(gene_dir)``): int if every cell
is an int, else float if every cell is a float (pandas' NA strings and empty
cells are NaN), else str.  Row orders and
the gene selections are pandas' (``isin`` matches NaN with NaN;
``drop_duplicates`` keeps the first).  The gene signature is read from
``TCGA/gene_signature_selected.csv`` only: the reference's xlsx needs
openpyxl.
"""

from __future__ import annotations

import csv
import os
import re
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from sml_tpu_torch.config import Config
from sml_tpu_torch.data import h5, jpeg
from sml_tpu_torch.data.synthetic import QUANTILES_ALL, QUANTILES_UNCENSORED

# label-vector slot layout (reference data/dataset.py:523)
LABEL_SLOTS = ("IDH", "1p19q", "CDKN", "His", "Grade", "Diag2021", "His_2class",
               "Subtype", "survival_bin", "censor", "event", "survival_time")

# pandas' default NA strings (pandas._libs.parsers.STR_NA_VALUES)
NA_STRINGS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"})
_WS = r"[ \t\r\f\v]*"
_INT = rf"{_WS}[+-]?\d+{_WS}"
_FLOAT = (rf"{_WS}[+-]?(?:\d+\.?\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?"
          rf"|[iI][nN][fF](?:[iI][nN][iI][tT][yY])?){_WS}")
_INT64 = (-2 ** 63, 2 ** 63 - 1)
_NAN_KEY = object()              # NaN as a set or dict key: all NaNs are one


def _key(v):
    return _NAN_KEY if v != v else v


def _every(pattern: str, cells: List[str]) -> bool:
    """Whether every cell matches ``pattern``: one match over the joined
    cells (a GDC column has 60k), cell by cell where a cell holds a newline."""
    if any("\n" in c for c in cells):
        return all(re.fullmatch(pattern, c) for c in cells)
    return not cells or re.fullmatch(rf"(?:{pattern})(?:\n(?:{pattern}))*",
                                     "\n".join(cells)) is not None


def _column(cells: Sequence[str]) -> Tuple[str, list]:
    """(kind, values) of one column, typed as pandas' default C parser types it."""
    present = [c for c in cells if c not in NA_STRINGS]
    nan = float("nan")
    if present and len(present) == len(cells) and _every(_INT, present):
        ints = [int(c) for c in cells]
        if all(_INT64[0] <= v <= _INT64[1] for v in ints):
            return "int", ints
    if _every(_FLOAT, present):
        return "float", [nan if c in NA_STRINGS else float(c) for c in cells]
    return "str", [nan if c in NA_STRINGS else c for c in cells]


class Table:
    """Typed columns by name, in file order: the part of a pandas DataFrame
    the readers use."""

    def __init__(self, columns: Dict[str, Tuple[str, list]]):
        self.columns = columns

    @classmethod
    def read(cls, path: str, sep: str = ",", skiprows: int = 0,
             usecols: Sequence[str] = ()) -> "Table":
        """``pd.read_csv(path, sep=sep, skiprows=skiprows, header=0,
        usecols=usecols or None)``; blank lines are skipped.  Each column is
        typed on its own, so reading fewer changes none."""
        with open(path, newline="") as f:
            for _ in range(skiprows):
                f.readline()
            rows = [r for r in csv.reader(f, delimiter=sep) if r]
        header, body = rows[0], rows[1:]
        width = len(header)
        if any(len(r) != width for r in body):
            for i, r in enumerate(body):
                if len(r) > width:
                    raise ValueError(f"{path}: line {i + 2 + skiprows} has {len(r)} "
                                     f"fields, the header {width}")
            body = [r + [""] * (width - len(r)) for r in body]   # short rows: NaN
        names = list(usecols) or header
        missing = [n for n in names if n not in header]
        if missing:
            raise KeyError(f"{path}: no column {missing}")
        by_position = list(zip(*body)) or [()] * width
        return cls({n: _column(list(by_position[header.index(n)])) for n in names})

    def __len__(self) -> int:
        return len(next(iter(self.columns.values()))[1]) if self.columns else 0

    def col(self, name: str) -> list:
        return self.columns[name][1]

    def col_array(self, name: str) -> np.ndarray:
        """``df[name].values``: int64, float64 or object."""
        kind, vals = self.columns[name]
        dt = {"int": np.int64, "float": np.float64}.get(kind, object)
        if dt is object:
            out = np.empty(len(vals), dtype=object)
            out[:] = vals
            return out
        return np.asarray(vals, dtype=dt)

    def values(self) -> np.ndarray:
        """``df.values``: int64 if every column is int, float64 if every column
        is numeric, else object (Python values)."""
        kinds = {k for k, _ in self.columns.values()}
        dt = (np.int64 if kinds == {"int"} else np.float64 if kinds <= {"int", "float"}
              else object)
        cols = [v for _, v in self.columns.values()]
        if dt is object:
            out = np.empty((len(self), len(cols)), dtype=object)
            for j, v in enumerate(cols):
                out[:, j] = v
            return out
        return np.asarray(cols, dtype=dt).T.reshape(len(self), len(cols))

    def take(self, rows: Sequence[int]) -> "Table":
        return Table({n: (k, [v[i] for i in rows]) for n, (k, v) in self.columns.items()})

    def where(self, name: str, keep) -> "Table":
        """The rows whose cell in column ``name`` satisfies ``keep``."""
        return self.take([i for i, v in enumerate(self.col(name)) if keep(v)])


def isin(values: Sequence, targets: Sequence) -> List[bool]:
    """pandas ``Series.isin``: Python equality, and NaN matches NaN."""
    keys = {_key(t) for t in targets}
    return [_key(v) in keys for v in values]


def drop_duplicates(table: Table, name: str) -> Table:
    """``df.drop_duplicates(subset=[name], keep="first")`` (NaNs are equal)."""
    first: Dict = {}
    for i, v in enumerate(table.col(name)):
        first.setdefault(_key(v), i)
    return table.take(sorted(first.values()))


def _read_gene_signature(data_dir: str) -> Tuple[Table, Table, Table]:
    path = os.path.join(data_dir, "TCGA", "gene_signature_selected.csv")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"gene signature {path} not found: the port reads the signature as CSV "
            "(the columns of gene_signature_selected.xlsx, sheet 0.3_high_exp)")
    share = Table.read(path)
    return (share, share.where("Type", lambda t: t == "Tumor"),
            share.where("Type", lambda t: t == "Immune"))


def _patient_split(patients: np.ndarray, seed: int, novalset: bool) -> Dict[str, set]:
    rng = np.random.RandomState(seed)
    patients = np.unique(patients)
    rng.shuffle(patients)
    n = len(patients)
    if novalset:
        return {"Train": set(patients[: int(n * 0.67)]),
                "Val": set(),
                "Test": set(patients[int(n * 0.67):])}
    return {"Train": set(patients[: int(n * 0.8)]),
            "Test": set(patients[int(n * 0.8): int(n * 0.9)]),
            "Val": set(patients[int(n * 0.9):])}


def _quantiles(config: Config) -> Tuple[float, float, float]:
    return (QUANTILES_UNCENSORED if config.survival_interval == "uncensored"
            else QUANTILES_ALL)


def _survival_bin(t: float, q: Tuple[float, float, float]) -> int:
    return 0 if t < q[0] else 1 if t < q[1] else 2 if t < q[2] else 3


def _diag_labels(idh: str, codel: str, cdkn, grade: str) -> Tuple[int, int]:
    """(diag2021, subtype): the WHO-2021 rule (reference dataset.py:224-241)."""
    if idh == "WT":
        return 0, 0                                  # Grade-4 GBM
    if codel == "codel":
        return 3, 2                                  # Oligo
    if cdkn in (-2, -1) or grade == "G4":
        return 1, 1                                  # Grade-4 Astro
    return 2, 1                                      # Grade-2/3 Astro


def _grade_label(grade: str) -> int:
    return 0 if grade == "G2" else 1 if grade == "G3" else 2


def _rows_of(table: np.ndarray, phase: str, config: Config) -> np.ndarray:
    split = _patient_split(table[:, 0], config.seed, config.novalset)[phase]
    return np.asarray([r for r in table if r[0] in split])


class _H5FeatureReader:
    def __init__(self, root: str):
        self.root = root

    def __call__(self, slide_id: str) -> np.ndarray:
        return h5.read(os.path.join(self.root, f"{slide_id}.h5"),
                       "Res_feature")[0].astype(np.float32)


def bag_rows(num: int, max_num: int) -> List[int]:
    """The detail row of each of the bag's ``max_num`` rows, as the JAX
    reader picks them: the patches repeated in order (``times`` copies, then
    the first ``remaining``), or, over ``max_num``, every ``num / max_num``-th
    rounded half to even."""
    if num <= max_num:
        times, remaining = max_num // num, max_num % num
        return list(range(num)) * times + list(range(num))[:remaining]
    idx = [int(np.around(i * (num / max_num))) for i in range(max_num)]
    return [min(i, num - 1) for i in idx]


class RawPatchReader:
    """End-to-end raw-JPEG bag reader (counterpart of the JAX
    ``RawPatchReader``; reference ``read_img``, dataset.py:142-186).

    Reads the patch JPEGs listed in ``read_details/{slide}.npy``, pads by
    repetition (or uniformly subsamples) to exactly ``fixdim`` patches and
    returns a (fixdim, patch_size * patch_size * 3) float32 tensor in [0, 1]
    on ``device``, each patch decoded once by the port's decoder
    (``data/jpeg.py``: entropy stage on host threads, pixel stage by the
    ``jpeg_pixels`` kernel on a card); bit for bit the JAX reader's array.
    """

    def __init__(self, cohort_dir: str, wsi_root: str, fixdim: int,
                 patch_size: int = 224, device="cuda"):
        self.cohort_dir = cohort_dir
        self.wsi_root = wsi_root
        self.fixdim = fixdim
        self.patch_size = patch_size
        self.device = torch.device(device)

    def __call__(self, slide_id: str) -> torch.Tensor:
        details = np.load(os.path.join(self.cohort_dir, "read_details",
                                       f"{slide_id}.npy"), allow_pickle=True)[0]
        wsi_path = os.path.join(self.wsi_root, slide_id)
        names = [os.path.join(wsi_path, f"{details[i][0]}_{details[i][1]}.jpg")
                 for i in bag_rows(details.shape[0], self.fixdim)]
        distinct = {name: k for k, name in enumerate(dict.fromkeys(names))}
        size = self.patch_size
        out = torch.empty((self.fixdim, size, size, 3), dtype=torch.float32,
                          device=self.device)
        jpeg.decode_into(list(distinct), [distinct[n] for n in names], out)
        return out.view(self.fixdim, -1)


def _slide_reader(config: Config, cohort: str, if_end2end: bool, device):
    """A cohort's x_path reader: its raw patch JPEGs (``if_end2end``) or its
    ResNet-50 feature files."""
    root = os.path.join(config.dataDir, cohort)
    if if_end2end:
        return RawPatchReader(root, os.path.join(root, "wsi"), config.fixdim, device=device)
    return _H5FeatureReader(os.path.join(root, f"Res50_feature_{config.fixdim}_fixdim0_norm"))


class IvYGAPDataset:
    """Allen-Institute IvYGAP cohort: fpkm gene tables joined by specimen name."""

    def __init__(self, phase: str, config: Config, if_end2end: bool = False,
                 device="cuda"):
        self.config, self.phase = config, phase
        d = config.dataDir
        table = Table.read(os.path.join(d, "IvYGAP", "multimodal_diag_survival_IvY.csv"))
        self.rows = _rows_of(table.values(), phase, config)

        gdir = os.path.join(d, "IvYGAP", "gene_expression_matrix_2014-11-25")
        rows_genes = Table.read(os.path.join(gdir, "rows-genes.csv"))
        self.columns_samples = Table.read(os.path.join(gdir, "columns-samples.csv"))
        fpkm = Table.read(os.path.join(gdir, "fpkm_table.csv"))

        share, tumor, immune = _read_gene_signature(d)
        gene_col = "gene_id\\rna_well_id"

        def select(sig: Table) -> Table:
            genes = [g for g, hit in zip(rows_genes.col("gene_id"),
                                         isin(rows_genes.col("gene_symbol"),
                                              sig.col("gene_symbol"))) if hit]
            return fpkm.take([i for i, hit in enumerate(isin(fpkm.col(gene_col), genes))
                              if hit])

        self.fpkm, self.fpkm_tumor, self.fpkm_immune = (select(share), select(tumor),
                                                         select(immune))
        self.specimens = ["-".join(x.split("-")[:3])
                          for x in self.columns_samples.col("specimen_name")]
        self.quantiles = _quantiles(config)
        self.read_feature = _slide_reader(config, "IvYGAP", if_end2end, device)

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        row = self.rows[index]
        wsi = self.read_feature(row[1])
        omic, tumor, immune = self._genes(row[1])
        return {"x_path": wsi, "x_omic": omic, "x_omic_tumor": tumor,
                "x_omic_immune": immune, "labels": self._labels(row)}

    def _genes(self, wsi_id: str):
        specimen = "-".join(wsi_id.split("-")[:3])
        match = [i for i, s in enumerate(self.specimens) if s == specimen]
        if not match:
            raise KeyError(f"specimen {specimen} not in IvYGAP gene table")
        well = str(self.columns_samples.col("rna_well_id")[match[0]])
        return tuple(t.col_array(well).astype(np.float32)
                     for t in (self.fpkm, self.fpkm_tumor, self.fpkm_immune))

    def _labels(self, row) -> np.ndarray:
        grade = _grade_label(row[3])
        diag, subtype = _diag_labels(row[4], row[5], row[6], row[3])
        t = float(row[-1])
        surv_bin = _survival_bin(t, self.quantiles)
        dead = row[-2] == 1
        censor, event = (0, 1) if dead else (1, 0)
        # IvYGAP zero-fills molecular slots 0-3 and 6 (reference dataset.py:269)
        return np.asarray([0, 0, 0, 0, grade, diag, 0, subtype, surv_bin, censor,
                           event, t], dtype=np.float32)


class TCGADataset:
    """TCGA cohort: per-sample GDC gene-expression TSVs, richer molecular labels."""

    def __init__(self, phase: str, config: Config, if_end2end: bool = False,
                 device="cuda"):
        self.config, self.phase = config, phase
        d = config.dataDir
        table = Table.read(os.path.join(d, "TCGA", "multimodal_diag_survival_TCGA.csv"))
        self.rows = _rows_of(table.values(), phase, config)
        self.share, self.share_tumor, self.share_immune = _read_gene_signature(d)
        self.quantiles = _quantiles(config)
        self.read_feature = _slide_reader(config, "TCGA", if_end2end, device)
        self.gene_root = os.path.join(d, "TCGA", "transcriptomeProfiling_geneExpression")
        # each sample's gene vectors, parsed once: a GDC file has ~60k rows
        self._genes_of: Dict[str, Tuple[np.ndarray, ...]] = {}

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        row = self.rows[index]
        wsi = self.read_feature(row[1])
        omic, tumor, immune = self._genes(row)
        return {"x_path": wsi, "x_omic": omic, "x_omic_tumor": tumor,
                "x_omic_immune": immune, "labels": self._labels(row)}

    def _genes(self, row):
        path = os.path.join(self.gene_root, str(row[11]), str(row[12]))
        if path not in self._genes_of:
            df = drop_duplicates(Table.read(path, sep="\t", skiprows=1,
                                            usecols=("gene_name", "fpkm_uq_unstranded")),
                                 "gene_name")

            def pick(sig: Table) -> np.ndarray:
                hits = isin(df.col("gene_name"), sig.col("gene_symbol"))
                sel = df.take([i for i, hit in enumerate(hits) if hit])
                return sel.col_array("fpkm_uq_unstranded").astype(np.float32)

            self._genes_of[path] = (pick(self.share), pick(self.share_tumor),
                                    pick(self.share_immune))
        return tuple(v.copy() for v in self._genes_of[path])

    def _labels(self, row) -> np.ndarray:
        idh = 0 if row[4] == "WT" else 1
        codel = 1 if row[5] == "codel" else 0
        cdkn = 1 if row[6] in (-2, -1) else 0
        his_map = {"oligoastrocytoma": 0, "astrocytoma": 1, "oligodendroglioma": 2,
                   "glioblastoma": 3}
        his = his_map.get(row[2], 0)
        his2 = 1 if row[2] == "glioblastoma" else 0
        grade = _grade_label(row[3])
        diag, subtype = _diag_labels(row[4], row[5], row[6], row[3])
        t = float(row[-1])
        surv_bin = _survival_bin(t, self.quantiles)
        dead = row[-2] == 1
        censor, event = (0, 1) if dead else (1, 0)
        return np.asarray([idh, codel, cdkn, his, grade, diag, his2, subtype,
                           surv_bin, censor, event, t], dtype=np.float32)
