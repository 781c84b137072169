"""The port's JPEG decoder (``sml_tpu_torch/data/jpeg.py``: the entropy stage in
``runtime/jpeg.cpp``, the pixel stage's plain version on the CPU) against PIL,
byte for byte, on every layout it reads; its refusals; the committed fixtures;
and, on a machine with a CUDA card, the ``jpeg_pixels`` kernel against its
plain version."""

import os
import shutil
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from sml_tpu_torch import runtime
from sml_tpu_torch.data import jpeg
from sml_tpu_torch.ops.kernels import jpeg as kernel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "data", "jpeg")
sys.path.insert(0, os.path.join(REPO, "scripts"))
from make_jpeg_fixtures import BAG_LAYOUTS, LAYOUTS, texture, write  # noqa: E402


@pytest.fixture()
def one_thread():
    """One intra-op thread: the plain pixel stage's small tensors are bound by
    dispatch, and a thread pool per test worker oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pil(path: str) -> np.ndarray:
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def _as_440(src: str, dst: str) -> None:
    """A 4:4:0 file (luma 1x2) from a square 4:2:2 one (luma 2x1): the MCUs hold
    the same four blocks, so re-marking the luma's sampling byte in SOF0 gives a
    valid file (of shuffled blocks), which PIL decodes with its h1v2 path."""
    data = bytearray(open(src, "rb").read())
    at = data.index(b"\xff\xc0") + 11            # marker, length, P, Y, X, Nf, C1 id
    assert data[at] == 0x21
    data[at] = 0x12
    open(dst, "wb").write(bytes(data))


@pytest.mark.parametrize("layout", list(LAYOUTS) + ["q75_440"])
def test_decoder_matches_pil(layout, tmp_path, one_thread):
    """Quality 50 / 75 / 95, 4:2:0 / 4:2:2 / 4:4:4 / 4:4:0, grey, optimised
    Huffman tables, restart markers every 4 MCUs, and a 100 x 60 image (edges
    inside an MCU): every byte PIL's."""
    rng = np.random.default_rng(sum(map(ord, layout)))
    path = str(tmp_path / f"{layout}.jpg")
    if layout == "q75_440":
        write(str(tmp_path / "src.jpg"), "q75_422", rng)
        _as_440(str(tmp_path / "src.jpg"), path)
    else:
        write(path, layout, rng)
    got = jpeg.decode([path], "cpu")
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got[0].numpy(), _pil(path))
    _, hdr, _ = jpeg.read([path])
    if layout == "restart4":
        assert int(hdr[0, kernel.RESTART]) == 4
    if layout == "q75_440":
        assert (int(hdr[0, kernel.HMAX]), int(hdr[0, kernel.VMAX])) == (1, 2)


def test_tiny_images_match_pil(tmp_path, one_thread):
    """Images a few pixels wide and high, 4:4:4 / 4:2:2 / 4:2:0: chroma 1 or 2
    samples wide takes libjpeg's box filter, wider the fancy one; every edge
    falls inside one MCU."""
    rng = np.random.default_rng(1)
    for height, width in [(1, 1), (4, 4), (3, 5), (6, 3), (7, 1), (9, 17)]:
        for sub in (0, 1, 2):
            path = str(tmp_path / f"{height}x{width}_{sub}.jpg")
            img = rng.integers(0, 255, (height, width, 3), dtype=np.uint8)
            Image.fromarray(img).save(path, quality=80, subsampling=sub)
            np.testing.assert_array_equal(jpeg.decode([path])[0].numpy(), _pil(path),
                                          err_msg=path)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_committed_fixtures_decode_as_pil(layout, one_thread):
    path = os.path.join(FIXTURES, f"{layout}.jpg")
    np.testing.assert_array_equal(jpeg.decode([path])[0].numpy(), _pil(path))


def test_a_bag_of_mixed_layouts_is_pils_over_255(one_thread):
    """``decode_into``: every 224 x 224 layout in one bag, rows repeated and out
    of order, equal to JAX's ``np.asarray(bag, np.float32) / 255.0``."""
    paths = [os.path.join(FIXTURES, f"{k}.jpg") for k in BAG_LAYOUTS]
    index = [3, 0, 7, 7, 1, 2, 6, 5, 4, 0, 3]
    out = torch.empty((len(index), 224, 224, 3))
    jpeg.decode_into(paths, index, out)
    want = np.asarray([_pil(paths[i]) for i in index], dtype=np.float32) / 255.0
    np.testing.assert_array_equal(out.numpy(), want)


@pytest.mark.parametrize("kind, match", [
    ("progressive", "progressive JPEG \\(SOF2\\)"),
    ("truncated", "entropy data ends early"),
    ("cmyk", "4-component JPEG \\(CMYK"),
])
def test_unsupported_files_raise_by_name(kind, match, tmp_path):
    rng = np.random.default_rng(3)
    path = str(tmp_path / f"{kind}.jpg")
    img = Image.fromarray(texture(rng, 64, 64, False))
    if kind == "progressive":
        img.save(path, progressive=True)
    elif kind == "cmyk":
        img.convert("CMYK").save(path)
    else:
        img.save(path)
        data = open(path, "rb").read()
        open(path, "wb").write(data[:len(data) // 2])
        with pytest.raises(OSError, match="truncated"):         # PIL refuses it too
            _pil(path)
    with pytest.raises(ValueError, match=match) as err:
        jpeg.decode([path])
    assert path in str(err.value)


def test_a_patch_of_another_size_raises_naming_it():
    paths = [os.path.join(FIXTURES, f"{k}.jpg") for k in ("q75_420", "q75_420_100x60")]
    with pytest.raises(ValueError, match="q75_420_100x60.jpg: a 100x60 patch"):
        jpeg.decode_into(paths, [0, 1], torch.empty((2, 224, 224, 3)))
    with pytest.raises(FileNotFoundError, match="missing.jpg"):
        jpeg.decode([os.path.join(FIXTURES, "missing.jpg")])


def test_a_failed_entropy_stage_build_raises(tmp_path, monkeypatch):
    broken = tmp_path / "jpeg.cpp"
    shutil.copy(runtime.JPEG_SRC, broken)
    broken.write_text(broken.read_text().replace("jpg_header_ints() {", "jpg_header_ints( {"))
    monkeypatch.setattr(runtime, "JPEG_SRC", broken)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        jpeg.decode([os.path.join(FIXTURES, "q75_420.jpg")])
    assert not runtime.library_path(broken).exists()


def test_plain_idct_is_jidctint_on_extreme_blocks():
    """DC-only blocks (the C code's short cut), a lone AC term, and values that
    reach the range limit's wrap (& RANGE_MASK), against a scalar transcription
    of ``jpeg_idct_islow``."""
    rng = np.random.default_rng(0)
    blocks = np.zeros((6, 8, 8), np.int16)
    blocks[0, 0, 0] = 40
    blocks[1, 0, 0], blocks[1, 3, 5] = -60, 9
    blocks[2] = rng.integers(-30, 30, (8, 8))
    blocks[3, 0, 0], blocks[3, 0, 1] = 600, -500            # overshoot: clamp and wrap
    blocks[4] = rng.integers(-200, 200, (8, 8))
    blocks[5, 0, 0] = -1024
    quant = rng.integers(1, 16, (6, 8, 8)).astype(np.int32)
    quant[3], quant[5] = 8, 1
    got = kernel.idct_islow(torch.from_numpy(blocks), torch.from_numpy(quant)).numpy()
    for b in range(6):
        np.testing.assert_array_equal(got[b], _scalar_islow(blocks[b], quant[b]), err_msg=b)


def _scalar_islow(coef, quant):
    """``jpeg_idct_islow`` line by line in Python ints (64-bit, as JLONG)."""
    def descale(x, n):
        return (x + (1 << (n - 1))) >> n

    def one_d(v, shift):
        z2, z3 = v[2], v[6]
        z1 = (z2 + z3) * 4433
        tmp2, tmp3 = z1 + z3 * -15137, z1 + z2 * 6270
        tmp0, tmp1 = (v[0] + v[4]) << 13, (v[0] - v[4]) << 13
        t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
        tmp0, tmp1, tmp2, tmp3 = v[7], v[5], v[3], v[1]
        z1, z2, z3, z4 = tmp0 + tmp3, tmp1 + tmp2, tmp0 + tmp2, tmp1 + tmp3
        z5 = (z3 + z4) * 9633
        tmp0, tmp1, tmp2, tmp3 = tmp0 * 2446, tmp1 * 16819, tmp2 * 25172, tmp3 * 12299
        z1, z2, z3, z4 = z1 * -7373, z2 * -20995, z3 * -16069 + z5, z4 * -3196 + z5
        tmp0, tmp1, tmp2, tmp3 = tmp0 + z1 + z3, tmp1 + z2 + z4, tmp2 + z2 + z3, tmp3 + z1 + z4
        return [descale(x, shift) for x in (t10 + tmp3, t11 + tmp2, t12 + tmp1, t13 + tmp0,
                                            t13 - tmp0, t12 - tmp1, t11 - tmp2, t10 - tmp3)]

    d = [[int(coef[k, c]) * int(quant[k, c]) for c in range(8)] for k in range(8)]
    ws = [[0] * 8 for _ in range(8)]
    for c in range(8):
        col = one_d([d[k][c] for k in range(8)], 11)
        for k in range(8):
            ws[k][c] = col[k]
    return np.asarray([[kernel.IDCT_LIMIT[x & 1023] for x in one_d(ws[r], 18)]
                       for r in range(8)])


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
def test_cuda_jpeg_pixels_matches_plain(dtype):
    dev = _cuda()
    paths = [os.path.join(FIXTURES, f"{k}.jpg") for k in BAG_LAYOUTS]
    coef, hdr, offsets = jpeg.read(paths, pin=True)
    index = torch.tensor([5, 1, 1, 0, 7, 2, 3, 4, 6, 0], dtype=torch.int64)
    want = kernel.jpeg_pixels_plain(coef, hdr, offsets, index,
                                    torch.empty((10, 224, 224, 3), dtype=dtype))
    got = kernel.jpeg_pixels(coef.to(dev), hdr, offsets, index,
                             torch.empty((10, 224, 224, 3), dtype=dtype, device=dev))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
