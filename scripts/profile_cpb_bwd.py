#!/usr/bin/env python3
"""Device time of the CPB kernels, forward and backward, per dtype and shape,
on one CUDA card.

    python3 scripts/profile_cpb_bwd.py [--tag NAME] [--csrc DIR] [--iters 20]
                                       [--variant threeblocks|rna|onetile|nodw1|
                                                  fwdonetile|fwdfiveblocks]

Builds ``cpb_bias.cu`` and ``cpb_bias_bwd.cu`` from ``--csrc`` (default: the
package's ``sml_tpu_torch/csrc``; a directory holding variants of the sources
and their shared headers, such as another commit's, compares them in the same
call) into ``build/profile_cpb/<tag>/``, prints each kernel instantiation's
registers and spill stores from the ptxas logs, with its SASS instructions
and the ``HMMA`` among them (``cuobjdump``, where the toolkit has it), and
those of its step loop (the innermost loop holding the most ``HMMA``: the
body of a backward branch), then the layer-2 mask check of ``chip_smoke.py``
(``cpb_mask_check``: the f32 forward's and backward's counts of z2 > 0 per
column, at its ragged shapes, dm 8 / 16 / 32, on random and boundary
inputs; ``"pass": "mask"``), then, at the main path's
shapes (BG = 64, dm = 32; S2500: 50 x 50 queries, J = 144; S4096: 64 x 64, J =
256), f32 and bf16, for the forward (``"pass": "fwd"``) and the backward
(``"bwd"``): the largest error against the plain version (the forward's
largest absolute error, the backward's largest relative L2 error of a
gradient), whether a second launch repeats the first bit for bit, a digest
of the output's bits (equal digests of two trees: equal results, the inputs
being drawn in the same order), and the median device time of one launch
over ``--iters`` CUDA-event timings.  One JSON line per item, prefixed with
``--tag``, so that runs of two sources can be told apart.

``--variant`` builds the f32 kernels from a copy of the sources with one
design choice changed (several, comma-separated, apply together).  Of the
backward (``tf32::cpb_bias_bwd_tf32``): ``threeblocks`` names three blocks an
SM in its launch bound instead of two (ptxas then gives each thread at most
168 registers), ``rna`` splits dw1's staged operand g h1 to nearest
(``mma::split_tf32``) instead of truncating it, ``onetile`` takes one m16
tile of pairs a warp step instead of two; and ``nodw1``, a timing ablation
whose gradients are wrong, leaves dw1's products out.  Of the forward
(``tf32::cpb_bias_fwd_tf32``): ``fwdonetile`` takes one m16 tile of pairs a
warp step instead of two, ``fwdfiveblocks`` names five blocks an SM in its
launch bound instead of four (at most 102 registers a thread).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import CPB_RAGGED, cpb_mask_check  # noqa: E402
from sml_tpu_torch.ops.kernels import (_build, cpb_bias, cpb_bias_bwd,  # noqa: E402
                                       cpb_bias_bwd_plain, cpb_bias_plain)

SOURCES = ("cpb_bias", "cpb_bias_bwd")
KERNEL = re.compile(r"(cpb_bias_fwd_tc|cpb_bias_bwd_tc|cpb_bias_fwd_tf32|cpb_bias_bwd_tf32)"
                    r"I(\w*?)Li(\d+)E")
# the variants of the f32 backward: ((file, its text, the variant's), ...)
VARIANTS = {
    "threeblocks": (("cpb_bias_bwd.cu", "constexpr int kBlocksPerSM = 2;",
                     "constexpr int kBlocksPerSM = 3;"),),
    "rna": (("cpb_bias_bwd.cu", "mma::split_tf32_trunc(", "mma::split_tf32("),),
    "onetile": (("cpb_bias_bwd.cu", "constexpr int kTiles = 2;", "constexpr int kTiles = 1;"),),
    # a timing ablation, whose gradients are wrong: dw1's products left out
    "nodw1": (("cpb_bias_bwd.cu", "            mma::mma_tf32(acc_w1[mt][n], al, b.x, b.y);\n"
               "            mma::mma_tf32(acc_w1[mt][n], ah, b.x, b.y);\n", ""),),
    "fwdonetile": (("cpb_bias.cu", "constexpr int kTiles = 2;", "constexpr int kTiles = 1;"),),
    "fwdfiveblocks": (("cpb_bias.cu", "constexpr int kBlocksPerSM = 4;",
                       "constexpr int kBlocksPerSM = 5;"),),
}

BG, DM = 64, 32
SHAPES = {2500: (50, 144), 4096: (64, 256)}       # fixdim -> (query side, J)


def _time_ms(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    pairs = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def _step_loop(code: list) -> tuple:
    """(SASS instructions, HMMA) of the innermost loop holding the most HMMA
    in a kernel's ``code`` [(address, instruction), ...]: of the bodies from
    a backward branch's target to the branch, those with the most HMMA, the
    shortest; (0, 0) without one."""
    loops = []
    for addr, text in code:
        m = re.search(r"\bBRA\S*\s+(?:`\()?(0x[0-9a-f]+)", text)
        if m and int(m.group(1), 16) <= addr:
            body = [x for a, x in code if int(m.group(1), 16) <= a <= addr]
            loops.append((sum("HMMA" in x for x in body), -len(body)))
    if not loops:
        return 0, 0
    hmma, neg_len = max(loops)
    return -neg_len, hmma


def _sass_counts(lib: Path) -> dict:
    """{mangled kernel: (SASS instructions, HMMA among them, and the same of
    its step loop)} of a library, by cuobjdump (the CUDA toolkit's); {}
    without it."""
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return {}
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True).stdout
    code, kernel = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            kernel = m.group(1)
            code[kernel] = []
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(\S.*?)\s*;", line)
        if kernel and m:
            code[kernel].append((int(m.group(1), 16), m.group(2)))
    return {k: (len(c), sum("HMMA" in x for _, x in c), *_step_loop(c))
            for k, c in code.items()}


def ptxas(tag: str) -> None:
    """Registers, spill stores, SASS instructions and HMMA of every kernel
    instantiation."""
    for src in SOURCES:
        sass = _sass_counts(_build.library_path(src))
        for mangled, (regs, spill) in _build.kernel_usage(_build.build_log(src)).items():
            k = KERNEL.search(mangled)
            name = (f"{k.group(1)}{'<' + k.group(2) + '>' if k.group(2) else ''} "
                    f"dm={k.group(3)}" if k else mangled)
            line = {"tag": tag, "kernel": name, "registers": regs, "spill_stores": spill}
            if mangled in sass:
                (line["sass_instructions"], line["hmma"], line["loop_sass_instructions"],
                 line["loop_hmma"]) = sass[mangled]
            print(json.dumps(line), flush=True)


def _digest(tensors) -> str:
    """The first 16 hex digits of a SHA-256 of the tensors' bits."""
    return hashlib.sha256(b"".join(
        a.contiguous().view(torch.int16 if a.dtype == torch.bfloat16 else torch.int32)
        .cpu().numpy().tobytes() for a in tensors)).hexdigest()[:16]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--csrc", default=str(_build.CSRC))
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--variant", help=f"one or more of {', '.join(VARIANTS)}, "
                    "comma-separated")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_cpb_bwd: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.CSRC = Path(args.csrc).resolve()
    _build.BUILD_DIR = ROOT / "build" / "profile_cpb" / args.tag
    if args.variant:
        csrc = _build.BUILD_DIR / "csrc"
        shutil.rmtree(csrc, ignore_errors=True)
        shutil.copytree(_build.CSRC, csrc)
        for name, text, variant in (c for v in args.variant.split(",") for c in VARIANTS[v]):
            src = csrc / name
            if text not in src.read_text():
                print(f"profile_cpb_bwd: {name} lacks the text of --variant {args.variant}",
                      file=sys.stderr)
                return 1
            src.write_text(src.read_text().replace(text, variant))
        _build.CSRC = csrc
    _build.build(SOURCES)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"tag": args.tag, "card": smi, "csrc": str(_build.CSRC)}), flush=True)
    ptxas(args.tag)
    for h, w, j in CPB_RAGGED:
        for dm in (8, 16, 32):
            for boundary in (False, True):
                e = cpb_mask_check(h, w, j, dm, boundary)
                print(json.dumps({"tag": args.tag, **{k: v for k, v in e.items()
                                                      if k != "bwd_counts"}}), flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    for fixdim, (side, j) in SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            def rn(*shape, scale=1.0):
                return torch.randn(*shape, device="cuda", generator=g) * scale
            inputs = [rn(BG, side * j, scale=0.7), rn(BG, side, j, scale=0.7)] + [
                w.to(dtype) for w in (rn(DM, scale=0.7), rn(DM, scale=0.7), rn(DM, scale=0.1),
                                      rn(DM, DM, scale=DM ** -0.5), rn(DM, scale=0.1),
                                      rn(DM, 1, scale=DM ** -0.5))]
            b2 = rn(1, scale=0.1).to(dtype)
            bias = cpb_bias(*inputs, b2)
            again = cpb_bias(*inputs, b2)
            print(json.dumps({"tag": args.tag, "pass": "fwd", "fixdim": fixdim,
                              "dtype": str(dtype).split(".")[-1],
                              "max_abs_err": (bias.float() - cpb_bias_plain(*inputs, b2).float()
                                              ).abs().max().item(),
                              "repeats": torch.equal(bias, again),
                              "digest": _digest([bias]),
                              "ms": _time_ms(lambda: cpb_bias(*inputs, b2), args.iters)}),
                  flush=True)
            del bias, again
            dbias = (rn(BG, side, side * j) * 1e-3).to(dtype)
            got = cpb_bias_bwd(*inputs, dbias)
            again = cpb_bias_bwd(*inputs, dbias)
            want = cpb_bias_bwd_plain(*inputs, dbias)
            rel = max(((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)).item()
                      for a, b in zip(got, want))
            print(json.dumps({"tag": args.tag, "pass": "bwd", "fixdim": fixdim,
                              "dtype": str(dtype).split(".")[-1],
                              "max_rel_l2_err": rel,
                              "repeats": all(torch.equal(a, b) for a, b in zip(got, again)),
                              "digest": _digest(got),
                              "ms": _time_ms(lambda: cpb_bias_bwd(*inputs, dbias), args.iters)}),
                  flush=True)
            del got, again, want, inputs, dbias
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
