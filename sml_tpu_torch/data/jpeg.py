"""The port's baseline JPEG decoder: PIL's bytes without PIL.

Two stages.  The entropy stage (``runtime/jpeg.cpp``, g++ at first use) reads
every file's markers and Huffman-decodes it on a pool of host threads into one
int16 coefficient buffer, pinned when the pixels go to the card.  The pixel
stage (``ops/kernels/jpeg.py``: the ``csrc/jpeg_pixels.cu`` kernels on a CUDA
tensor, the plain version on a CPU tensor) turns the coefficients into RGB, as
libjpeg-turbo's default decode path computes it (ISLOW IDCT, fancy chroma
upsampling, its YCbCr tables).  So only the coefficients cross to the card:
at 4:2:0 half a byte per pixel against the bag's twelve.

``decode(paths, device)`` gives a (n, H, W, 3) uint8 tensor, as
``np.asarray(Image.open(p).convert("RGB"))`` for each path;
``decode_into(paths, index, out)`` fills a bag: row r of ``out`` (rows, H, W,
3) float32 holds file ``paths[index[r]]`` / 255.  A file that cannot be
decoded raises, naming the file and the reason (progressive, arithmetic
coding, 12-bit, CMYK, truncated data, ...); there is no other decoder to fall
back on.
"""

from __future__ import annotations

import ctypes
import os
from typing import Sequence, Tuple

import numpy as np
import torch

from sml_tpu_torch import runtime
from sml_tpu_torch.ops.kernels.jpeg import COEFS, HEADER_INTS, HEIGHT, WIDTH, jpeg_pixels

THREADS = min(8, os.cpu_count() or 1)     # the entropy stage's host threads
_ERR_BYTES = 512


def _raise(paths: Sequence[str], rc: int, err) -> None:
    path, why = paths[rc - 1], err.value.decode(errors="replace")
    if why == "cannot open the file":
        raise FileNotFoundError(f"{path}: {why}")
    raise ValueError(f"{path}: {why}")


def read(paths: Sequence[str], pin: bool = False
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The entropy stage: (coef, hdr, offsets).  ``coef`` is one int16 CPU
    tensor (pinned with ``pin``) of every file's coefficients, ``hdr`` the
    (n, HEADER_INTS) int32 headers, ``offsets`` each file's first
    coefficient."""
    lib = runtime.load_jpeg()
    if lib.jpg_header_ints() != HEADER_INTS:
        raise RuntimeError("runtime/jpeg.cpp and ops/kernels/jpeg.py disagree on "
                           "the header layout")
    n = len(paths)
    encoded = [os.fsencode(p) for p in paths]
    c_paths = (ctypes.c_char_p * max(n, 1))(*encoded)
    err = ctypes.create_string_buffer(_ERR_BYTES)
    hdr = np.zeros((n, HEADER_INTS), dtype=np.int32)
    rc = lib.jpg_read_headers(n, c_paths, THREADS, hdr.ctypes.data, err, _ERR_BYTES)
    if rc:
        _raise(paths, rc, err)
    counts = hdr[:, COEFS].astype(np.int64)
    offsets = np.cumsum(counts) - counts
    coef = torch.empty(int(counts.sum()), dtype=torch.int16, pin_memory=pin)
    rc = lib.jpg_decode(n, c_paths, THREADS, hdr.ctypes.data, offsets.ctypes.data,
                        coef.data_ptr(), err, _ERR_BYTES)
    if rc:
        _raise(paths, rc, err)
    return coef, torch.from_numpy(hdr), torch.from_numpy(offsets)


def check_sizes(paths: Sequence[str], hdr: torch.Tensor, height: int, width: int) -> None:
    """Every file is ``width`` x ``height``, or ValueError naming the first
    that is not (JAX's ``np.asarray`` of a ragged bag fails too)."""
    for path, h in zip(paths, hdr):
        if (int(h[HEIGHT]), int(h[WIDTH])) != (height, width):
            raise ValueError(f"{path}: a {int(h[WIDTH])}x{int(h[HEIGHT])} patch in a bag of "
                             f"{width}x{height} patches")


def decode_into(paths: Sequence[str], index: Sequence[int], out: torch.Tensor) -> torch.Tensor:
    """Row r of ``out`` (rows, H, W, 3) float32, on the CPU or a card, = file
    ``paths[index[r]]`` as f32 / 255; each path is decoded once."""
    coef, hdr, offsets = read(paths, pin=out.device.type == "cuda")
    check_sizes(paths, hdr, out.shape[1], out.shape[2])
    coef = coef.to(out.device, non_blocking=True)
    return jpeg_pixels(coef, hdr, offsets, torch.as_tensor(index, dtype=torch.int64), out)


def decode(paths: Sequence[str], device="cpu") -> torch.Tensor:
    """(len(paths), H, W, 3) uint8 on ``device``: each file's RGB pixels (a grey
    file's in all three channels); every file must be of one size."""
    if not len(paths):
        raise ValueError("no paths to decode")
    coef, hdr, offsets = read(paths, pin=torch.device(device).type == "cuda")
    height, width = int(hdr[0, HEIGHT]), int(hdr[0, WIDTH])
    check_sizes(paths, hdr, height, width)
    out = torch.empty((len(paths), height, width, 3), dtype=torch.uint8, device=device)
    coef = coef.to(out.device, non_blocking=True)
    return jpeg_pixels(coef, hdr, offsets, torch.arange(len(paths)), out)
