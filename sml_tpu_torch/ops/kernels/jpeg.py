"""The pixel stage of the port's JPEG decoder (``csrc/jpeg_pixels.cu``, CUDA
C++ for sm_90a) beside its plain PyTorch version.

Replaces no Pallas kernel: the JAX package decodes raw patches with PIL on the
host (``sml_tpu/data/datasets.py:109-114``, ``RawPatchReader._load``), which the
card machine lacks.  The entropy stage runs on host threads
(``runtime/jpeg.cpp``) and hands over int16 coefficients; this stage turns
them into the bag ``RawPatchReader`` returns, libjpeg-turbo's default decode
path written out in integers, so that it gives PIL's bytes:

- dequantise (int16 x quantisation value, int32) and the ISLOW inverse DCT of
  ``jidctint.c`` (CONST_BITS 13, PASS1_BITS 2, its DESCALE rounding and its
  range-limit table indexed with ``& RANGE_MASK``);
- chroma upsampling as ``jdsample.c`` does by default: h2v1 "fancy" (3/4 and
  1/4 with biases 1 / 2), h2v2 fancy (biases 8 / 7 over the column sums of two
  rows), h1v2 fancy, the edges replicated at the component's own width and
  height; a box filter where a component is at most 2 samples wide; 1x1
  copies;
- YCbCr -> RGB with ``jdcolor.c``'s tables (SCALEBITS 16, ONE_HALF, the
  combined green term) and clamping; a grey file's L in R, G and B, as
  ``convert("RGB")`` gives it;
- ``float(v) / 255.0f``, a correctly rounded f32 division, as JAX's
  ``np.float32 array / 255.0`` (or the uint8 values themselves).

What bounds it on the H100: bytes.  Per 224 x 224 4:2:0 patch it reads 75,264
int16 coefficients (150.5 KB) and writes 150,528 f32 (602 KB) per bag row,
with about 40 integer operations per coefficient in the IDCT and about 30 per
output pixel: far below the card's ridge.  Its design: two simple kernels,
the IDCT per 8x8 block (one thread each) into uint8 planes in a scratch
buffer, then upsampling, colour and the f32 write per output pixel (one
thread each), every bag row from its file's planes, so a file repeated in a
bag is decoded once.  Speed is later work.

On CPU tensors the wrapper takes the plain version; on CUDA tensors it
launches the kernels or raises.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from sml_tpu_torch.ops.kernels import _build

# the header of one file, in int32 (kept equal to runtime/jpeg.cpp)
WIDTH, HEIGHT, COMPS, HMAX, VMAX, RESTART, COEFS = 0, 1, 2, 3, 4, 5, 6
COMP = 8                      # per component: h, v, blocks across, blocks down
QUANT = 20                    # per component: 64 quantisation values, natural order
HEADER_INTS = QUANT + 64 * 3

# jidctint.c
CONST_BITS, PASS1_BITS = 13, 2
FIX_0_298631336, FIX_0_390180644, FIX_0_541196100 = 2446, 3196, 4433
FIX_0_765366865, FIX_0_899976223, FIX_1_175875602 = 6270, 7373, 9633
FIX_1_501321110, FIX_1_847759065, FIX_1_961570560 = 12299, 15137, 16069
FIX_2_053119869, FIX_2_562915447, FIX_3_072711026 = 16819, 20995, 25172
RANGE_MASK = 1023


def _fix(x: float) -> int:            # jdcolor.c's FIX at SCALEBITS 16
    return int(x * 65536 + 0.5)


SCALEBITS, ONE_HALF = 16, 1 << 15
# jdcolor.c's build_ycc_rgb_table, indexed by the sample (x = sample - 128)
CR_R = [(_fix(1.40200) * (i - 128) + ONE_HALF) >> SCALEBITS for i in range(256)]
CB_B = [(_fix(1.77200) * (i - 128) + ONE_HALF) >> SCALEBITS for i in range(256)]
CR_G = [-_fix(0.71414) * (i - 128) for i in range(256)]
CB_G = [-_fix(0.34414) * (i - 128) + ONE_HALF for i in range(256)]
# the IDCT's range limit: sample_range_limit + CENTERJSAMPLE, indexed by
# DESCALE(...) & RANGE_MASK (jdmaster.c's prepare_range_limit_table)
IDCT_LIMIT = ([128 + t for t in range(128)] + [255] * 384 + [0] * 384
              + [t for t in range(128)])

GRID_Y = 65535                # files (IDCT grid) and bag rows (colour grid), one per grid row
_lib = None
_OUT_CODE = {torch.uint8: 0, torch.float32: 1}


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("jpeg_pixels")
        lib.jpeg_pixels.argtypes = ([ctypes.c_void_p] * 5
                                    + [ctypes.c_int] * 6 + [ctypes.c_void_p, ctypes.c_int,
                                                           ctypes.c_void_p])
        lib.jpeg_pixels.restype = ctypes.c_int
        _lib = lib
    return _lib


def _descale(x: torch.Tensor, n: int) -> torch.Tensor:
    return (x + (1 << (n - 1))) >> n


def _idct_1d(v, shift: int):
    """One pass of ``jpeg_idct_islow`` over eight int32 tensors (the inputs
    0..7 of a column or a row); returns the eight outputs descaled by
    ``shift``."""
    z2, z3 = v[2], v[6]
    z1 = (z2 + z3) * FIX_0_541196100
    tmp2 = z1 + z3 * -FIX_1_847759065
    tmp3 = z1 + z2 * FIX_0_765366865
    tmp0 = (v[0] + v[4]) << CONST_BITS
    tmp1 = (v[0] - v[4]) << CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    tmp0, tmp1, tmp2, tmp3 = v[7], v[5], v[3], v[1]
    z1, z2, z3, z4 = tmp0 + tmp3, tmp1 + tmp2, tmp0 + tmp2, tmp1 + tmp3
    z5 = (z3 + z4) * FIX_1_175875602
    tmp0 = tmp0 * FIX_0_298631336
    tmp1 = tmp1 * FIX_2_053119869
    tmp2 = tmp2 * FIX_3_072711026
    tmp3 = tmp3 * FIX_1_501321110
    z1 = z1 * -FIX_0_899976223
    z2 = z2 * -FIX_2_562915447
    z3 = z3 * -FIX_1_961570560 + z5
    z4 = z4 * -FIX_0_390180644 + z5
    tmp0 = tmp0 + z1 + z3
    tmp1 = tmp1 + z2 + z4
    tmp2 = tmp2 + z2 + z3
    tmp3 = tmp3 + z1 + z4
    return [_descale(a, shift) for a in (tmp10 + tmp3, tmp11 + tmp2, tmp12 + tmp1,
                                         tmp13 + tmp0, tmp13 - tmp0, tmp12 - tmp1,
                                         tmp11 - tmp2, tmp10 - tmp3)]


def idct_islow(blocks: torch.Tensor, quant: torch.Tensor) -> torch.Tensor:
    """(..., 8, 8) int16 coefficients (natural order) x quant (broadcast,
    int32) -> (..., 8, 8) samples 0..255 (int32), bit for bit
    ``jpeg_idct_islow``: columns first (pass 1), then rows (pass 2).  Each
    pass runs on contiguous slices (strided ones are many times slower on
    several threads)."""
    d = (blocks.int() * quant).movedim(-2, 0).contiguous()        # (k, ..., column)
    ws = torch.stack(_idct_1d(list(d), CONST_BITS - PASS1_BITS))  # (row, ..., column)
    ws = ws.movedim(-1, 0).contiguous()                           # (column, row, ...)
    out = torch.stack(_idct_1d(list(ws), CONST_BITS + PASS1_BITS + 3))
    limit = torch.tensor(IDCT_LIMIT, dtype=torch.int32, device=blocks.device)
    return limit[(out & RANGE_MASK).long()].movedim(0, -1).movedim(0, -2)


def _clamped(x: torch.Tensor, dim: int, step: int) -> torch.Tensor:
    """x shifted by one along ``dim`` (step -1: the previous sample, +1: the
    next), the edge sample repeated."""
    n = x.shape[dim]
    idx = torch.arange(n, device=x.device) + step
    return x.index_select(dim, idx.clamp(0, n - 1))


def _interleave(even: torch.Tensor, odd: torch.Tensor, dim: int) -> torch.Tensor:
    """``even`` and ``odd`` samples interleaved along ``dim`` (-1 or -2)."""
    return torch.stack((even, odd), dim=dim).flatten(dim - 1, dim)


def upsample(c: torch.Tensor, h: int, v: int) -> torch.Tensor:
    """(n, ch, cw) int32 chroma at its own size -> (n, v*ch, h*cw): libjpeg-
    turbo's fancy upsampling (``jdsample.c``) for h, v in {1, 2}; a box
    filter for h2v1 / h2v2 where the component is at most 2 samples wide."""
    if h == 1 and v == 1:
        return c
    if h == 2 and c.shape[-1] <= 2:
        return c.repeat_interleave(2, dim=-1).repeat_interleave(v, dim=-2)
    if h == 2 and v == 1:                                  # h2v1_fancy_upsample
        near = 3 * c
        return _interleave((near + _clamped(c, -1, -1) + 1) >> 2,
                           (near + _clamped(c, -1, 1) + 2) >> 2, -1)
    if h == 1:                                             # h1v2_fancy_upsample
        near = 3 * c
        return _interleave((near + _clamped(c, -2, -1) + 1) >> 2,
                           (near + _clamped(c, -2, 1) + 2) >> 2, -2)
    near = 3 * c                                           # h2v2_fancy_upsample
    rows = _interleave(near + _clamped(c, -2, -1), near + _clamped(c, -2, 1), -2)
    this = 3 * rows
    return _interleave((this + _clamped(rows, -1, -1) + 8) >> 4,
                       (this + _clamped(rows, -1, 1) + 7) >> 4, -1)


def ycc_to_rgb(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor) -> torch.Tensor:
    """int32 planes -> (..., 3) int32 RGB, ``jdcolor.c``'s ``ycc_rgb_convert``."""
    tab = {k: torch.tensor(t, dtype=torch.int32, device=y.device)
           for k, t in (("crr", CR_R), ("cbb", CB_B), ("crg", CR_G), ("cbg", CB_G))}
    cb, cr = cb.long(), cr.long()
    r = y + tab["crr"][cr]
    g = y + ((tab["cbg"][cb] + tab["crg"][cr]) >> SCALEBITS)
    b = y + tab["cbb"][cb]
    return torch.stack((r, g, b), dim=-1).clamp(0, 255)


def _planes(coef: torch.Tensor, hdr: torch.Tensor, offsets: torch.Tensor, files) -> list:
    """The IDCT's sample planes of ``files`` (one layout), one (n, rows,
    cols) int32 tensor per component, padded to whole blocks."""
    h0 = hdr[files[0]]
    planes, first = [], 0
    for c in range(int(h0[COMPS])):
        bw, bh = int(h0[COMP + 4 * c + 2]), int(h0[COMP + 4 * c + 3])
        count = bw * bh * 64
        blocks = torch.stack([coef[int(offsets[f]) + first:int(offsets[f]) + first + count]
                              for f in files]).view(len(files), bh, bw, 8, 8)
        quant = torch.stack([hdr[f, QUANT + 64 * c:QUANT + 64 * c + 64] for f in files])
        samples = idct_islow(blocks, quant.view(len(files), 1, 1, 8, 8).to(coef.device))
        planes.append(samples.permute(0, 1, 3, 2, 4).reshape(len(files), bh * 8, bw * 8))
        first += count
    return planes


def _rgb(coef, hdr, offsets, files) -> torch.Tensor:
    """(n, H, W, 3) int32 RGB of ``files``, which share one layout."""
    h0 = hdr[files[0]]
    width, height, hmax, vmax = (int(h0[k]) for k in (WIDTH, HEIGHT, HMAX, VMAX))
    planes = _planes(coef, hdr, offsets, files)
    y = planes[0][:, :height, :width]
    if len(planes) == 1:
        return y.unsqueeze(-1).expand(*y.shape, 3)
    ch, cw = -(-height // vmax), -(-width // hmax)
    cb, cr = (upsample(p[:, :ch, :cw], hmax, vmax)[:, :height, :width] for p in planes[1:])
    return ycc_to_rgb(y, cb, cr)


def _layout(h: torch.Tensor) -> Tuple[int, ...]:
    """Size, components and sampling: they fix every component's block grid."""
    return tuple(int(h[k]) for k in (WIDTH, HEIGHT, COMPS, HMAX, VMAX))


def _check(coef, hdr, offsets, index, out):
    """Validate; returns (height, width) of the bag's patches."""
    if coef.dtype != torch.int16 or coef.dim() != 1:
        raise TypeError("coef must be a 1-D int16 tensor")
    if hdr.dtype != torch.int32 or hdr.dim() != 2 or hdr.shape[1] != HEADER_INTS:
        raise ValueError(f"hdr must be an int32 (n, {HEADER_INTS}) tensor")
    if offsets.dtype != torch.int64 or tuple(offsets.shape) != (hdr.shape[0],):
        raise ValueError("offsets must be an int64 (n,) tensor")
    if index.dtype != torch.int64 or index.dim() != 1:
        raise ValueError("index must be a 1-D int64 tensor")
    for t in (hdr, offsets, index):
        if t.device.type != "cpu":
            raise ValueError("hdr, offsets and index are host tables")
    if out.dtype not in _OUT_CODE or out.dim() != 4 or out.shape[-1] != 3:
        raise ValueError("out must be a (rows, H, W, 3) uint8 or float32 tensor")
    if out.shape[0] != index.shape[0] or coef.device != out.device:
        raise ValueError("out must have a row per index, on coef's device")
    if not (coef.is_contiguous() and out.is_contiguous()):
        raise ValueError("coef and out must be contiguous")
    n = hdr.shape[0]
    if len(index) and (int(index.min()) < 0 or int(index.max()) >= n):
        raise ValueError(f"index outside the {n} files")
    height, width = out.shape[1], out.shape[2]
    ends = offsets + hdr[:, COEFS].long()
    if n and (int(offsets.min()) < 0 or int(ends.max()) > coef.numel()):
        raise ValueError("a file's coefficients lie outside coef")
    used = torch.unique(index)
    sizes = hdr[used][:, [HEIGHT, WIDTH]]
    if len(used) and not bool((sizes == torch.tensor([height, width], dtype=torch.int32)).all()):
        raise ValueError(f"every file of the bag must be {width}x{height}")
    return height, width


def jpeg_pixels_plain(coef, hdr, offsets, index, out):
    """``out[r]`` = the RGB pixels of file ``index[r]`` (uint8, or f32 / 255),
    from the entropy stage's coefficients, in int32 PyTorch operations on
    ``coef``'s device: the arithmetic of ``csrc/jpeg_pixels.cu``.  Files of one
    layout (size, components, sampling) go together, at most 64 at a time."""
    _check(coef, hdr, offsets, index, out)
    groups: Dict[Tuple[int, ...], list] = {}
    for f in torch.unique(index).tolist():
        groups.setdefault(_layout(hdr[f]), []).append(f)
    for files in groups.values():
        for start in range(0, len(files), 64):
            rgb = _rgb(coef, hdr, offsets, files[start:start + 64])
            chunk = torch.tensor(files[start:start + 64])
            # a 0-dim tensor divisor: PyTorch's CUDA division by a Python
            # scalar multiplies by its reciprocal, one ulp off numpy's v / 255
            value = (rgb.to(torch.uint8) if out.dtype == torch.uint8
                     else rgb.float() / torch.full((), 255.0, device=rgb.device))
            rows = torch.nonzero(torch.isin(index, chunk)).flatten()
            at = torch.searchsorted(chunk, index[rows]).to(out.device)
            out.index_copy_(0, rows.to(out.device), value.index_select(0, at))
    return out


def jpeg_pixels(coef, hdr, offsets, index, out):
    """Fill ``out`` (rows, H, W, 3), uint8 or float32, with the pixels of file
    ``index[r]`` in row r, as PIL's ``np.asarray(im.convert("RGB"))`` (f32:
    divided by 255 in f32).

    ``coef`` is the entropy stage's int16 coefficient buffer on ``out``'s
    device; ``hdr`` (n, HEADER_INTS) int32, ``offsets`` (n,) int64 (each
    file's first coefficient) and ``index`` (rows,) int64 are host tables
    (``data/jpeg.py`` makes them).  CPU tensors take the plain version; CUDA
    tensors launch the kernels, each distinct file's IDCT once.
    """
    height, width = _check(coef, hdr, offsets, index, out)
    if out.device.type == "cpu":
        return jpeg_pixels_plain(coef, hdr, offsets, index, out)
    if out.device.type != "cuda":
        raise ValueError(f"jpeg_pixels runs on cpu or cuda, not {out.device}")
    n = hdr.shape[0]
    if n > GRID_Y or out.shape[0] > GRID_Y:
        raise ValueError(f"jpeg_pixels kernel takes at most {GRID_Y} files and rows")
    if coef.data_ptr() % 16:
        raise ValueError("jpeg_pixels kernel reads coef in 16-byte words: align it")
    max_blocks = int(hdr[:, COEFS].max()) // 64 if n else 0
    lib = _library()
    dev = out.device
    hdr_d, off_d, idx_d = (t.to(dev, non_blocking=True) for t in (hdr, offsets, index))
    scratch = torch.empty(coef.numel(), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.jpeg_pixels(coef.data_ptr(), hdr_d.data_ptr(), off_d.data_ptr(),
                             idx_d.data_ptr(), scratch.data_ptr(), n, max_blocks,
                             out.shape[0], height, width, _OUT_CODE[out.dtype],
                             out.data_ptr(), dev.index, stream)
    _build.check(rc, "jpeg_pixels")
    jpeg_pixels.launches += 1
    return out


jpeg_pixels.launches = 0
