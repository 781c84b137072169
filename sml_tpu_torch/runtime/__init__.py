"""Native runtime of the port: the C++ threaded batch prefetcher
(``prefetch.cpp``) and the JPEG decoder's entropy stage (``jpeg.cpp``).

``load_library()`` and ``load_jpeg()`` compile their source with ``g++ -O2
-shared -fPIC -pthread`` at first use into
``build/sml_tpu_torch/lib<name>-<hash>.so`` at the root of the checkout
(git-ignored, keyed by the source and the flags, as ``ops/kernels/_build.py``
keys the CUDA libraries), never into the package, and return its ``ctypes``
handle.  A failed build raises: neither the packed loader nor the raw patch
reader has a silent fallback.  Nothing builds at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

SRC = Path(__file__).resolve().parent / "prefetch.cpp"
JPEG_SRC = Path(__file__).resolve().parent / "jpeg.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "sml_tpu_torch"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_loaded: Dict[Path, ctypes.CDLL] = {}


def library_path(src: Path = SRC) -> Path:
    digest = hashlib.sha256(src.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{src.stem}-{digest[:16]}.so"


def build(src: Path = SRC) -> Path:
    """Compile ``src`` unless its library exists; raises on a failed build."""
    target = library_path(src)
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, str(src), "-o", str(tmp)],
                              capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"building {src.name} needs g++ on PATH") from e
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed to build {src}:\n{proc.stderr[-2000:]}")
    os.replace(tmp, target)
    return target


def load_library(src: Optional[Path] = None) -> ctypes.CDLL:
    """The prefetcher built from ``src`` (default ``SRC``), with its C
    signatures declared."""
    with _lock:
        path = build(src or SRC)
        lib = _loaded.get(path)
        if lib is None:
            lib = ctypes.CDLL(str(path))
            lib.pf_open.restype = ctypes.c_void_p
            lib.pf_open.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                                    ctypes.c_int64, ctypes.c_int64]
            lib.pf_submit.restype = ctypes.c_int64
            lib.pf_submit.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
                                      ctypes.c_int64]
            lib.pf_next.restype = ctypes.POINTER(ctypes.c_uint8)
            lib.pf_next.argtypes = [ctypes.c_void_p]
            lib.pf_close.restype = None
            lib.pf_close.argtypes = [ctypes.c_void_p]
            _loaded[path] = lib
        return lib


def load_jpeg() -> ctypes.CDLL:
    """The JPEG entropy stage built from ``JPEG_SRC``, with its C signatures
    declared."""
    with _lock:
        path = build(JPEG_SRC)
        lib = _loaded.get(path)
        if lib is None:
            lib = ctypes.CDLL(str(path))
            lib.jpg_header_ints.restype = ctypes.c_int
            lib.jpg_header_ints.argtypes = []
            lib.jpg_read_headers.restype = ctypes.c_int
            lib.jpg_read_headers.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_char_p),
                                             ctypes.c_int, ctypes.c_void_p, ctypes.c_char_p,
                                             ctypes.c_int]
            lib.jpg_decode.restype = ctypes.c_int
            lib.jpg_decode.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_char_p),
                                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
            _loaded[path] = lib
        return lib
