#!/usr/bin/env python3
"""Device time of the attention kernels, forward and backward, form by form, on one CUDA card.

    python3 scripts/profile_attn_bwd.py [--tag NAME] [--csrc DIR] [--iters 10]
                                        [--dtype bfloat16|float32] [--cases REGEX]
                                        [--variant nofold|onechain|unrolled|rna64|
                                                   oneblock64|allhalves64|skiprows64|
                                                   droppair64]

Builds ``deform_attn.cu`` and ``deform_attn_bwd.cu`` from ``--csrc`` (default:
the package's ``sml_tpu_torch/csrc``; a directory holding variants of the
sources and their shared headers, such as another commit's, compares them in
the same call) into ``build/profile_attn/<tag>/`` and prints, for each kernel
instantiation of the two builds, its registers and spill stores from the
ptxas log.  Then, at the main path's shapes (BG=64, in ``--dtype``: bf16, the
tensor-core kernels, or f32, the forward's and the backward's tf32
kernels): for the forward
(``"pass": "fwd"``) in every form the main paths run (the bias form without
and with dropout at S2500 / S4096, the bias-less and span Nystrom chains 1 and
3 at S2500 / S4096, the span form with bias and dropout at S2500), the largest
error against the plain version, whether a second launch repeats the first
bit for bit, a digest of the output's bits, and the median device time of one launch over ``--iters``
CUDA-event timings; for the backward (``"pass": "bwd"``: the bias form without
and with dropout, the bias-less chains), the largest gradient error against
the plain version relative to that tensor's max, a digest of the gradients'
bits (equal digests of two trees: equal results), and the device time per
launch of the rows and keys kernels under ``torch.profiler`` (mean of
``--iters`` launches).  The dh = 64 lines of both passes also give the
case's bound as ``chip_smoke.py`` counts it (``_attn_bound``; span forms:
the valid pairs), the plain version's median time over 5 launches, and that
of one ``F.scaled_dot_product_attention`` call of the same function (the bias
as its mask in q's dtype, a span as a 0 / -inf mask; none with dropout), as
``chip_smoke.py`` times it; the f32 lines also its bound at 3xTF32
(``chip_smoke._tf32x3``), and after every other backward case the span forms
(TransMIL's chains 1 and 3 at S2500 and the span form with a bias and
dropout at S2500), last so that the inputs of the cases before them are
drawn as a tree without them draws them.  ``--cases`` runs only the forward
and backward cases whose names it matches (a tree whose backward work query
takes no dtype, given by ``--csrc``, runs every case but the dh = 32 ones; one
whose forward work query takes none, from before the f32 dh = 64 forward's
tf32 kernel, runs every case, its query called without the dtype).
In f32 both passes also run CMTA's two chains on the
dh = 32 form (BG = 64, 128 landmarks, n_pad 2560), which runs on the tf32
tensor cores in both directions: the backward's rows, keys and combine
kernels are timed apart.  In bf16 both passes also run the f32 bias beside
bf16 q, k, v at the 1-D path's shape (``f32bias_d1``: N 2501, J 625) and the
bf16 bias at the deform-masked shape (``bias_s2000``: fixdim 2000 padded to
45 x 45, N 2025, J 121), and the ``"pass": "ragged"`` lines give, for the bf16
and the f32 bias at every residue of J mod 8 (and N = 65, one row past a
64-row tile), a digest of the forward's and the backward's bits and whether a
second launch repeats them: equal digests of two trees show that the two
trees' kernels give the same bits there (the shapes of ``chip_smoke.py``'s
phase 3, ``RAGGED`` and ``RAGGED_BIAS``).
Its lines also give the largest gradient error of each gradient's max
against float64, of the kernel and of the f32 plain version.  Two variants,
built from a copy of the sources, measure what the design does to that
error: ``--variant nofold`` keeps one tensor-core accumulator over each whole
walk instead of one per tile folded into an f32 sum (``kFoldTiles`` in
``attn_tf32.cuh``); ``--variant onechain`` sums the three tf32 products of
each f32 product in one accumulator instead of the big one apart from the
two small ones (``mma_3xtf32`` in ``mma.cuh``); ``--variant unrolled``
unrolls the two 32-key halves of the shared statistics walk (``stats_tile``
in ``attn_tf32.cuh``), to show its registers and spills.  Four measure the
dh = 64 kernels' choices: ``rna64`` splits each operand with hi and lo
rounded (``split_tf32``, five operations) instead of truncated
(``split_tf32_trunc``, two); ``oneblock64`` drops the two-blocks-an-SM launch
bound; ``allhalves64`` walks the rows kernel through every 32-key half of
the last key tile; ``skiprows64`` skips the keys kernel's 16-row steps past
N; ``droppair64`` draws the forward's dropout multipliers pair by pair
(``drop_pair``, each 4-key Philox group twice) instead of once for a lane
pair (``rows_keep_bits``).  One line per item, prefixed
with ``--tag``, so that runs of two trees can be told apart.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import (RAGGED, RAGGED_BIAS, _attn_bound, _attn_work,  # noqa: E402
                        _sdpa_ms, _span_work, _tf32x3, _time_ms)
from sml_tpu_torch.ops.kernels import (_build, deform_attention_bwd,  # noqa: E402
                                       deform_attention_bwd_plain, deform_attention_fwd,
                                       deform_attention_fwd_plain, philox_keep_mask)
from sml_tpu_torch.ops.kernels.deform_attn import _span_valid  # noqa: E402

SOURCES = ("deform_attn", "deform_attn_bwd")
BG, DH, SEED = 64, 64, 7
# the bias: None, "same" (q's dtype) or "f32" (beside bf16 q, k, v: bf16 runs only)
# forward, name: (N, J, bias, keep_prob, span)
FWD_CASES = {
    "bias_s2500": (2500, 144, "same", 1.0, False),
    "bias_drop_s2500": (2500, 144, "same", 0.9, False),
    "bias_s4096": (4096, 256, "same", 1.0, False),
    "bias_drop_s4096": (4096, 256, "same", 0.9, False),
    "ch3_s2500": (256, 2560, None, 1.0, False), "ch1_s2500": (2560, 256, None, 1.0, False),
    "ch3_s4096": (256, 4352, None, 1.0, False), "ch1_s4096": (4352, 256, None, 1.0, False),
    "ch3_span_s2500": (256, 2560, None, 1.0, True),
    "ch1_span_s2500": (2560, 256, None, 1.0, True),
    "ch3_span_s4096": (256, 4352, None, 1.0, True),
    "ch1_span_s4096": (4352, 256, None, 1.0, True),
    "span_bias_drop_s2500": (2500, 144, "same", 0.9, True),
    "bias_s2000": (2025, 121, "same", 1.0, False),
    "f32bias_d1": (2501, 625, "f32", 1.0, False)}
# backward, name: (N, J, bias, keep_prob, span)
BWD_CASES = {"bias_s2500": (2500, 144, "same", 1.0, False),
             "bias_drop_s2500": (2500, 144, "same", 0.9, False),
             "bias_s4096": (4096, 256, "same", 1.0, False),
             "bias_drop_s4096": (4096, 256, "same", 0.9, False),
             "ch3_s2500": (256, 2560, None, 1.0, False), "ch1_s2500": (2560, 256, None, 1.0, False),
             "ch3_s4096": (256, 4352, None, 1.0, False), "ch1_s4096": (4352, 256, None, 1.0, False),
             "bias_s2000": (2025, 121, "same", 1.0, False),
             "f32bias_d1": (2501, 625, "f32", 1.0, False)}
# f32 only, after every other backward case: the span forms
BWD_SPAN_CASES = {"ch3_span_s2500": (256, 2560, None, 1.0, True),
                  "ch1_span_s2500": (2560, 256, None, 1.0, True),
                  "span_bias_drop_s2500": (2500, 144, "same", 0.9, True)}
# the variants of the f32 backward: (file, its text, the variant's); the first
# three of the dh = 32 kernels, the rest of the dh = 64 ones
VARIANTS = {
    "nofold": ("attn_tf32.cuh", "constexpr bool kFoldTiles = true;",
               "constexpr bool kFoldTiles = false;"),
    "onechain": ("mma.cuh", "mma_tf32(small, al, bh0, bh1);\n  mma_tf32(small, ah, bl0, bl1);",
                 "mma_tf32(big, al, bh0, bh1);\n  mma_tf32(big, ah, bl0, bl1);"),
    "unrolled": ("attn_tf32.cuh", "#pragma unroll 1\n  for (int c0 = 0; c0 < kBlock; c0 += 32)",
                 "#pragma unroll\n  for (int c0 = 0; c0 < kBlock; c0 += 32)"),
    # each dh = 64 operand split as dh = 32 splits it (hi and lo rounded)
    "rna64": ("mma.cuh", "  hi = __float_as_uint(x) & 0xffffe000u;\n"
              "  lo = __float_as_uint(x - __uint_as_float(hi));",
              "  split_tf32(x, hi, lo);"),
    # the dh = 64 kernels without the two-blocks-an-SM bound (ptxas then
    # spills some instantiations)
    "oneblock64": ("deform_attn_bwd.cu", "__launch_bounds__(kThreads, 2)",
                   "__launch_bounds__(kThreads)"),
    # the dh = 64 rows kernel walking a key tile's every 32-key half
    "allhalves64": ("deform_attn_bwd.cu",
                    "const int c_end = wrow0 < N ? min(kBlock, J - j0) : 0;",
                    "const int c_end = kBlock;"),
    # the dh = 64 keys kernel skipping the 16-row steps past N and its warps
    # past J (a runtime trip count)
    "skiprows64": ("deform_attn_bwd.cu", "    for (int rs = 0; rs < kBlock; rs += 16) {\n"
                   "      // st[i][2h + w], dpt[i][2h + w]: key key[h], row r0 + rs",
                   "    for (int rs = 0; rs < (kw0 < J ? min(kBlock, N - r0) : 0); rs += 16) {\n"
                   "      // st[i][2h + w], dpt[i][2h + w]: key key[h], row r0 + rs"),
    # the dh = 64 forward drawing each pair's Philox group by drop_pair, as the
    # backward's rows kernel does, instead of once for a lane pair
    "droppair64": ("deform_attn.cu",
                   "          const float m = !DROP ? 1.f : ((kept >> (16 * h + 4 * i + (e & 1))) "
                   "& 1u ? inv_keep\n"
                   "                                                                                  : 0.f);",
                   "          const float2 mp = !DROP ? make_float2(1.f, 1.f) : tc::drop_pair(\n"
                   "              seed, j0 + c0 + 8 * i + col, row[h], bg, keep_prob, inv_keep);\n"
                   "          const float m = e & 1 ? mp.y : mp.x;"),
}
# f32 only: CMTA's chains on the dh = 32 form, name: (N, J)
DH32_CASES = {"ch3_dh32_s2500": (128, 2560), "ch1_dh32_s2500": (2560, 128)}
KERNEL = re.compile(r"(attn_fwd_tc|attn_bwd_rows_tc|attn_bwd_keys_tc|deform_attn_fwd_kernel"
                    r"|attn_bwd_rows_kernel|attn_bwd_keys_kernel)I(\w+?)EEv")
TF32 = re.compile(r"(attn_fwd_tf32|attn_bwd_rows_tf32|attn_bwd_keys_tf32|attn_bwd_combine)"
                  r"(?:ILb(\d)ELb(\d)E)?")
# the f32 dh = 64 kernels: (bias, span, dropout[, statistics, gradients or output])
TF32_64 = re.compile(r"attn_(fwd|bwd_rows|bwd_keys)_tf32_64I((?:Lb\dE)+)")
# device-time roles of the backward's kernels
ROLE = re.compile(r"attn_bwd_((rows|keys)_(tc|kernel|tf32)|combine)")


def _kernel_name(mangled: str) -> str:
    k, t, t64 = KERNEL.search(mangled), TF32.search(mangled), TF32_64.search(mangled)
    if t64:
        flags = re.findall(r"Lb(\d)", t64.group(2))
        names = ("bias", "span", "drop", "stats", "out" if t64.group(1) == "fwd" else "grad")
        return f"attn_{t64.group(1)}_tf32_64 f32 dh=64 " + " ".join(
            f"{n}={f}" for n, f in zip(names, flags))
    if k:
        bias, span, drop = re.findall(r"Lb(\d)", k.group(2))
        dtype = "f32" if k.group(2).startswith("f") else "bf16"
        dh = re.search(r"Li(\d+)E", k.group(2))
        f32_bias = k.group(1).endswith("_tc") and k.group(2).endswith("f")  # BT = float
        return (f"{k.group(1)} {dtype} bias={'f32' if f32_bias else bias} span={span} "
                f"drop={drop}" + (f" dh={dh.group(1)}" if dh else ""))
    if t:
        second = "out" if t.group(1) == "attn_fwd_tf32" else "grad"
        return t.group(1) + (f" stats={t.group(2)} {second}={t.group(3)}" if t.group(2) else "")
    return mangled


def _sass_counts(lib: Path) -> dict:
    """{mangled kernel: (SASS instructions, HMMA among them)} of a library,
    by cuobjdump (the CUDA toolkit's); {} without it."""
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return {}
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True).stdout
    counts, kernel = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            kernel = m.group(1)
            counts[kernel] = [0, 0]
        elif kernel and re.search(r"/\*[0-9a-f]{4,}\*/\s+\S", line):
            counts[kernel][0] += 1
            counts[kernel][1] += "HMMA" in line
    return counts


def ptxas(tag: str) -> None:
    """Registers and spill stores of every kernel instantiation, and for the
    tf32 kernels their SASS instructions beside their HMMA."""
    for src in SOURCES:
        sass = _sass_counts(_build.library_path(src))
        for mangled, (regs, spill) in _build.kernel_usage(_build.build_log(src)).items():
            line = {"tag": tag, "kernel": _kernel_name(mangled), "registers": regs,
                    "spill_stores": spill}
            if (TF32.search(mangled) or TF32_64.search(mangled)) and mangled in sass:
                line["sass_instructions"], line["hmma"] = sass[mangled]
            print(json.dumps(line), flush=True)


def _spans(n: int, j: int) -> torch.Tensor:
    """(BG, 4) int32 intervals: every sixteenth bag whole, then a bag with no
    valid row, the rest random."""
    g = torch.Generator().manual_seed(n + j)
    r0 = torch.randint(0, n // 2, (BG,), generator=g)
    c0 = torch.randint(0, j // 2, (BG,), generator=g)
    span = torch.stack([r0, r0 + torch.randint(1, n // 2, (BG,), generator=g),
                        c0, c0 + torch.randint(1, j // 2, (BG,), generator=g)], dim=1)
    span[::16] = torch.tensor([0, n, 0, j])
    span[1::16, :2] = n
    return span.to(torch.int32).cuda()


def _digest(tensors) -> str:
    """The first 16 hex digits of a SHA-256 of the tensors' bits."""
    return hashlib.sha256(b"".join(
        a.view(torch.int16 if a.dtype == torch.bfloat16 else torch.int32).cpu().numpy()
        .tobytes() for a in tensors if a is not None)).hexdigest()[:16]


def _bias(spec, n: int, j: int, g: torch.Generator, bf: torch.dtype):
    """The (BG, n, j) bias of a case: None, in ``bf`` ("same") or f32 ("f32")."""
    if spec is None:
        return None
    return torch.randn(BG, n, j, device="cuda", generator=g).to(
        torch.float32 if spec == "f32" else bf)


def _bias_size(spec, dtype: torch.dtype) -> int:
    """Bytes a pair of a case's bias: 0 without one."""
    return 0 if spec is None else 4 if spec == "f32" else torch.finfo(dtype).bits // 8


def _library_ms(q, k, v, bias, span, keep_prob: float, iters: int, dout=None):
    """The time of one F.scaled_dot_product_attention forward (with ``dout``:
    its backward, ``chip_smoke._sdpa_ms``) of the same function: the bias as
    its mask in q's dtype, a span as a 0 / -inf mask; None with dropout,
    which SDPA draws otherwise, or where PyTorch does not run the form."""
    if keep_prob < 1:
        return None
    mask = None if bias is None else bias.to(q.dtype)
    if span is not None:
        rv, cv = _span_valid(span, q.shape[1], k.shape[1])
        mask = torch.zeros(rv.shape[0], q.shape[1], k.shape[1], dtype=q.dtype,
                           device="cuda").masked_fill_(~(rv & cv), float("-inf"))
    if dout is None:
        return _time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                               scale=1.0), iters)
    return _sdpa_ms(q, k, v, dout, mask, mask_grad=bias is not None)[1]


def _cases(cases: dict, bf: torch.dtype):
    """The cases this dtype runs: the f32 bias only beside bf16 q, k, v."""
    return {name: c for name, c in cases.items() if c[2] != "f32" or bf == torch.bfloat16}


def forward(tag: str, iters: int, g: torch.Generator, bf: torch.dtype, pick) -> None:
    for name, (n, j, bias_spec, keep_prob, has_span) in _cases(FWD_CASES, bf).items():
        if not pick(name):
            continue
        rn = lambda *s, scale=1.0: (torch.randn(*s, device="cuda", generator=g) * scale).to(bf)
        q, k, v = rn(BG, n, DH, scale=DH ** -0.5), rn(BG, j, DH), rn(BG, j, DH)
        bias = _bias(bias_spec, n, j, g, bf)
        span = _spans(n, j) if has_span else None
        run = lambda: deform_attention_fwd(q, k, v, bias, keep_prob, SEED, span)
        out = run()
        again = run()
        keep = (philox_keep_mask(SEED, BG, n, j, keep_prob, device="cuda")
                if keep_prob < 1 else None)
        want = deform_attention_fwd_plain(q, k, v, bias, keep, keep_prob, span).float()
        plain = lambda: deform_attention_fwd_plain(  # the dropout form makes its mask
            q, k, v, bias, philox_keep_mask(SEED, BG, n, j, keep_prob, device="cuda")
            if keep_prob < 1 else None, keep_prob, span)
        work = None if span is None else _span_work(span, n, j)
        bias_size = _bias_size(bias_spec, bf)
        bound_ms, bound_by = _attn_bound(n, j, bf, bias_size, work=work)
        print(json.dumps({"tag": tag, "pass": "fwd", "case": name,
                          "max_abs_err": (out.float() - want).abs().max().item(),
                          "equal_share": (out.float() == want).float().mean().item(),
                          "repeats": torch.equal(out, again), "digest": _digest([out]),
                          "ms": _time_ms(run, iters), "plain_ms": _time_ms(plain, 5),
                          "library_ms": _library_ms(q, k, v, bias, span, keep_prob, iters),
                          "bound_ms": bound_ms, "bound_by": bound_by,
                          **_tf32x3(_attn_work(n, j, 4, bias_size, work=work), bf)}),
              flush=True)
        del q, k, v, bias, out, again, keep, want
        torch.cuda.empty_cache()
    for name, (n, j) in (DH32_CASES.items() if bf == torch.float32 else ()):
        if not pick(name):
            continue
        q = torch.randn(BG, n, 32, device="cuda", generator=g) * 32 ** -0.5
        k, v = torch.randn(2, BG, j, 32, device="cuda", generator=g)
        run = lambda: deform_attention_fwd(q, k, v)
        out = run()
        print(json.dumps({"tag": tag, "pass": "fwd", "case": name,
                          "max_abs_err": (out - deform_attention_fwd_plain(q, k, v)).abs()
                          .max().item(), "repeats": torch.equal(out, run()),
                          "digest": _digest([out]), "ms": _time_ms(run, iters)}), flush=True)


def _bwd_f64(q, k, v, dout):
    """(dq, dk, dv) of the bias-less attention in float64."""
    q, k, v, dout = (t.double() for t in (q, k, v, dout))
    p = torch.softmax(torch.einsum("bnd,bjd->bnj", q, k), dim=-1)
    dp = torch.einsum("bnd,bjd->bnj", dout, v)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    return (torch.einsum("bnj,bjd->bnd", ds, k), torch.einsum("bnj,bnd->bjd", ds, q),
            torch.einsum("bnj,bnd->bjd", p, dout))


def _err_of_scale(got, want) -> float:
    return max(((a.double() - b.double()).abs().max() / b.double().abs().max()).item()
               for a, b in zip(got, want) if a is not None)


def backward(tag: str, iters: int, g: torch.Generator, bf: torch.dtype, pick) -> None:
    cases = [(name, n, j, bias_spec, keep_prob, has_span, DH)
             for name, (n, j, bias_spec, keep_prob, has_span) in _cases(BWD_CASES, bf).items()]
    if bf == torch.float32:
        cases += [(name, n, j, None, 1.0, False, 32) for name, (n, j) in DH32_CASES.items()]
        cases += [(name, *c, DH) for name, c in BWD_SPAN_CASES.items()]
    for name, n, j, bias_spec, keep_prob, has_span, dh in cases:
        if not pick(name):
            continue
        rn = lambda *s, scale=1.0: (torch.randn(*s, device="cuda", generator=g) * scale).to(bf)
        q, k, v = rn(BG, n, dh, scale=dh ** -0.5), rn(BG, j, dh), rn(BG, j, dh)
        dout = rn(BG, n, dh, scale=1e-2)
        bias = _bias(bias_spec, n, j, g, bf)
        span = _spans(n, j) if has_span else None
        run = lambda: deform_attention_bwd(q, k, v, bias, dout, keep_prob, SEED, span)
        got = run()
        keep = (philox_keep_mask(SEED, BG, n, j, keep_prob, device="cuda")
                if keep_prob < 1 else None)
        want = deform_attention_bwd_plain(q, k, v, bias, dout, keep, keep_prob, span)
        err = _err_of_scale(got, want)
        extra = {}
        if dh == 32:
            exact = _bwd_f64(q, k, v, dout)
            extra = {"max_err_of_scale_f64": _err_of_scale(got, exact),
                     "plain_err_of_scale_f64": _err_of_scale(want, exact)}
            del exact
        else:
            work = None if span is None else _span_work(span, n, j)
            bias_size = _bias_size(bias_spec, bf)
            bound_ms, bound_by = _attn_bound(n, j, bf, bias_size, bwd=True, work=work)
            extra = {"plain_ms": _time_ms(lambda: deform_attention_bwd_plain(
                         q, k, v, bias, dout, philox_keep_mask(SEED, BG, n, j, keep_prob,
                                                               device="cuda")
                         if keep_prob < 1 else None, keep_prob, span), 5),
                     "library_ms": _library_ms(q, k, v, bias, span, keep_prob, iters, dout),
                     "bound_ms": bound_ms, "bound_by": bound_by}
            extra.update(_tf32x3(_attn_work(n, j, 4, bias_size, True, work), bf))
        again = run()
        repeats = all(a is None or torch.equal(a, b) for a, b in zip(got, again))
        digest = _digest(got)
        del want, keep, again
        for _ in range(3):
            run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                run()
            torch.cuda.synchronize()
        ms = {}
        for e in prof.key_averages():
            m = ROLE.search(e.key)
            if e.device_type == torch.autograd.DeviceType.CUDA and m:
                ms[m.group(1)] = round(ms.get(m.group(1), 0.0)
                                       + e.self_device_time_total / 1e3 / iters, 4)
        print(json.dumps({"tag": tag, "pass": "bwd", "case": name, "max_rel_err": err,
                          **extra, "repeats": repeats, "digest": digest, "ms": ms,
                          "total_ms": round(sum(ms.values()), 4)}), flush=True)
        del q, k, v, dout, bias, span, got
        torch.cuda.empty_cache()


def ragged(tag: str, g: torch.Generator) -> None:
    """Digests of the forward's and the backward's bits with the bf16 and the
    f32 bias (bf16 q, k, v) at chip_smoke.py's ragged shapes, and whether a
    second launch repeats them."""
    bf = torch.bfloat16
    for n, j in RAGGED + RAGGED_BIAS:
        for spec in ("same", "f32"):
            q = (torch.randn(BG, n, DH, device="cuda", generator=g) * DH ** -0.5).to(bf)
            k, v = torch.randn(2, BG, j, DH, device="cuda", generator=g).to(bf)
            dout = (torch.randn(BG, n, DH, device="cuda", generator=g) * 1e-2).to(bf)
            bias = _bias(spec, n, j, g, bf)
            out = deform_attention_fwd(q, k, v, bias)
            got = deform_attention_bwd(q, k, v, bias, dout)
            repeats = torch.equal(out, deform_attention_fwd(q, k, v, bias)) and all(
                torch.equal(a, b) for a, b in zip(got, deform_attention_bwd(q, k, v, bias, dout)))
            print(json.dumps({"tag": tag, "pass": "ragged", "case": f"{spec}_n{n}_j{j}",
                              "fwd_digest": _digest([out]), "bwd_digest": _digest(got),
                              "repeats": repeats}), flush=True)


def _old_fwd_work() -> None:
    """The forward's work query of a tree from before it took a dtype (its
    f32 dh = 64 forward took no scratch), behind the wrapper's five-argument
    call."""
    from sml_tpu_torch.ops.kernels.deform_attn import _library

    lib = _library("deform_attn")
    query = lib.deform_attn_fwd_work
    query.argtypes = [ctypes.c_int] * 4
    lib.deform_attn_fwd_work = lambda dtype, bg, n, j, dh: query(bg, n, j, dh)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--csrc", default=str(_build.CSRC))
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    ap.add_argument("--variant", choices=tuple(VARIANTS))
    ap.add_argument("--cases", default="", help="a regex: run only the cases it matches")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_attn_bwd: no CUDA device", file=sys.stderr)
        return 1
    _build.CSRC = Path(args.csrc).resolve()
    _build.BUILD_DIR = ROOT / "build" / "profile_attn" / args.tag
    if args.variant:
        name, text, variant = VARIANTS[args.variant]
        csrc = _build.BUILD_DIR / "csrc"
        shutil.rmtree(csrc, ignore_errors=True)
        shutil.copytree(_build.CSRC, csrc)
        src = csrc / name
        if text not in src.read_text():
            print(f"profile_attn_bwd: {name} lacks the text of --variant {args.variant}",
                  file=sys.stderr)
            return 1
        src.write_text(src.read_text().replace(text, variant))
        _build.CSRC = csrc
    _build.build(SOURCES)
    if "deform_attn_fwd_work(int BG" in (_build.CSRC / "deform_attn.cu").read_text():
        _old_fwd_work()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"tag": args.tag, "card": card, "csrc": str(_build.CSRC),
                      "dtype": args.dtype}), flush=True)
    ptxas(args.tag)
    g = torch.Generator(device="cuda").manual_seed(0)
    dtype = getattr(torch, args.dtype)
    pick = lambda name: re.search(args.cases, name) is not None
    forward(args.tag, args.iters, g, dtype, pick)
    backward(args.tag, args.iters, g, dtype, pick)
    if dtype == torch.bfloat16:
        ragged(args.tag, g)
    return 0


if __name__ == "__main__":
    sys.exit(main())
