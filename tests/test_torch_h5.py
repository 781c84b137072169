"""The port's HDF5 reader (``sml_tpu_torch/data/h5.py``) against h5py, bit for
bit, on the layouts h5py writes by default and with chunks, filters, an
unlimited dimension and other float types; its refusals; and the minimal
contiguous writer of ``chip_smoke.py`` read back by h5py."""

import numpy as np
import pytest

import h5py

import chip_smoke
from sml_tpu_torch.data import h5

SHAPE = (1, 301, 1030)        # uneven edge chunks along both axes of (1, 4, 1024)
LAYOUTS = {
    "contiguous": {},
    "chunked": dict(chunks=(1, 4, 1024)),
    "gzip": dict(chunks=(1, 16, 256), compression="gzip"),
    "shuffle_gzip": dict(chunks=(1, 16, 256), shuffle=True, compression="gzip"),
    "fletcher32": dict(chunks=(1, 16, 256), fletcher32=True),
    "shuffle_gzip_fletcher32": dict(chunks=(1, 16, 256), shuffle=True,
                                    compression="gzip", fletcher32=True),
    "maxshape": dict(maxshape=(None, None, 1030)),
}


def _data(dtype="<f4"):
    return np.random.default_rng(0).normal(size=SHAPE).astype(dtype)


def _same_bits(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_reads_the_layout_bit_for_bit(layout, tmp_path):
    path = str(tmp_path / "f.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("Res_feature", data=_data(), **LAYOUTS[layout])
    with h5py.File(path, "r") as f:
        want = f["Res_feature"][:]
    _same_bits(h5.read(path, "Res_feature"), want)


@pytest.mark.parametrize("dtype", ["<f2", "<f8", ">f4", ">f8"])
@pytest.mark.parametrize("chunked", [False, True])
def test_reads_other_floats_in_either_byte_order(dtype, chunked, tmp_path):
    path = str(tmp_path / "f.h5")
    kw = dict(chunks=(1, 16, 256), shuffle=True, compression="gzip") if chunked else {}
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=_data(dtype), **kw)
    with h5py.File(path, "r") as f:
        want = f["x"][:]
    _same_bits(h5.read(path, "x"), want)


def test_groups_of_many_symbol_nodes_and_b_tree_levels(tmp_path):
    """40 datasets need several SNODs; 300 a second B-tree level; a subgroup
    holds its own symbol table; unwritten chunks read as the fill value."""
    path = str(tmp_path / "f.h5")
    with h5py.File(path, "w") as f:
        for i in range(300):
            f.create_dataset(f"d{i:03d}", data=np.full((3,), i, np.float32))
        sub = f.create_group("sub")
        for i in range(40):
            sub.create_dataset(f"e{i}", data=np.arange(5, dtype=np.float32) + i)
        sub.create_dataset("sparse", shape=(20, 30), dtype="f4", chunks=(7, 7),
                           fillvalue=3.5)
        sub["sparse"][0:5, 0:5] = 1.0
    with h5py.File(path, "r") as f:
        want = {name: f[name][:] for name in ("d000", "d157", "d299", "sub/e0", "sub/e39",
                                              "sub/sparse")}
    for name, arr in want.items():
        _same_bits(h5.read(path, name), arr)
    with pytest.raises(KeyError, match="d300"):
        h5.read(path, "d300")


def test_refuses_libver_latest_lzf_and_an_unwritten_dataset(tmp_path):
    latest, lzf, empty = (str(tmp_path / n) for n in ("latest.h5", "lzf.h5", "empty.h5"))
    with h5py.File(latest, "w", libver="latest") as f:
        f.create_dataset("x", data=_data())
    with h5py.File(lzf, "w") as f:
        f.create_dataset("x", data=_data(), compression="lzf")
    with h5py.File(empty, "w") as f:
        f.create_dataset("x", shape=(2, 3), dtype="f4")
    with pytest.raises(NotImplementedError, match="superblock version 3"):
        h5.read(latest, "x")
    with pytest.raises(NotImplementedError, match="filter 32000 .lzf."):
        h5.read(lzf, "x")
    with pytest.raises(ValueError, match="never written"):
        h5.read(empty, "x")


def test_refuses_a_user_block_and_a_missing_fill_value_message(tmp_path):
    path = str(tmp_path / "ub.h5")
    with h5py.File(path, "w", userblock_size=512) as f:
        f.create_dataset("x", data=_data())
    with pytest.raises(ValueError, match="user block"):
        h5.read(path, "x")
    with pytest.raises(NotImplementedError, match="no fill value message"):
        h5._fill_value({}, np.dtype("<f4"))


def test_fletcher32_checksum_is_checked(tmp_path):
    path = str(tmp_path / "f.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=_data(), chunks=SHAPE, fletcher32=True)
        offset = f["x"].id.get_chunk_info(0).byte_offset
    with open(path, "r+b") as f:                  # flip one bit of the stored data
        f.seek(offset + 100)
        b = f.read(1)
        f.seek(offset + 100)
        f.write(bytes([b[0] ^ 1]))
    with pytest.raises(ValueError, match="fletcher32"):
        h5.read(path, "x")


def test_chip_smoke_writer_is_read_back_by_h5py(tmp_path):
    path = str(tmp_path / "slide.h5")
    x = _data()
    chip_smoke.write_h5(path, "Res_feature", x)
    with h5py.File(path, "r") as f:
        assert list(f) == ["Res_feature"]
        want = f["Res_feature"][:]
    _same_bits(want, x)
    _same_bits(h5.read(path, "Res_feature"), x)
