"""This tree's hand kernels against another checkout's, in one process on
the card.

    python -m etude_tpu_torch.tools.kernel_ab --other DIR [--json PATH]

DIR holds another checkout of the repository (for example the parent
commit, unpacked with `git archive`). Its `etude_tpu_torch/csrc/*.cu` are
built with this tree's nvcc flags and called through ctypes. K1's and K2's
launchers get the arguments this tree's wrappers pass, so they must take
the same ones (every design so far does). K2b's launcher is called through
its own argument list, read by name from its source: the PR 9 design takes
11 pointers (with its f32 p/ds scratch), the one-launch design 9. At the
shapes of `chip_smoke.py`'s kernels phase (K1, K2) and aux_train phase
(K2b), with L2 flushed, each kernel is first held against its plain
version (two bf16 ulps of the largest |o|; K2b's der within DER_RTOL of its
largest |value|), then timed in turns, other, this, this, other (medians of
50 launches each, `L2Flush` between launches), beside its bound, its plain
version and, for K1, masked `scaled_dot_product_attention`. At K1's serving
shape and K2's dilation 1 both are timed again with the write-only flush of
the earlier timings. One line per shape, the card's name and power limit,
then one JSON object of every row.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

from ..ops import _build
from ..ops.decode_attention import decode_attention, decode_attention_plain
from ..ops.dilated_attention import (
    ATTN_LEN, dilated_attention, dilated_attention_backward,
    dilated_attention_backward_plain, dilated_attention_plain, head_offsets,
)
from ..utils.kernel_bench import (
    L2Flush, attention_inputs, decode_bound, dilated_backward_bound, dilated_bound,
    dilated_inputs, kernel_tolerance, time_ms,
)

# K2b's der against the plain version's: within this share of its largest
# |value| (f32 sums over B*T in another order), as chip_smoke.py holds it.
DER_RTOL = 1e-3
NAMES = ("decode_attention", "dilated_attention", "dilated_attention_bwd")
K1_SHAPES = [(B, C) for B in (1, 16, 27) for C in (769, 1353)] + [(16, 1217)]
MAIN_K1 = (16, 1217)   # the serving shape
K2_SHAPES = ([(2048, 1, False), (2048, 256, False), (10336, 1, False), (10336, 256, False)]
             + [(12288, 2 ** i, False) for i in range(9)] + [(12288, 8, True)])
# K2b at the aux_train phase's shapes: (B, T, dilation, head7_bug).
K2B_SHAPES = ([(40, 512, 2 ** i, False) for i in range(9)]
              + [(5, 12288, d, False) for d in (1, 16, 256)]
              + [(40, 512, d, True) for d in (1, 8, 256)])


def build_other(root: Path):
    """nvcc for each of the other checkout's kernel sources, all at once;
    returns {name: CDLL}."""
    out_dir = _build.BUILD_DIR / "other"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in NAMES:
        src = root / "etude_tpu_torch" / "csrc" / f"{name}.cu"
        lib = out_dir / f"{name}.so"
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"building the other {name}.cu failed:\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  other {name}: {line.strip()}", flush=True)
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def other_decode(lib):
    fn = lib.decode_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(q, k, v, bias):
        B, H, C, D = k.shape
        out = torch.empty((B, H, D), dtype=torch.bfloat16, device=q.device)
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                out.data_ptr(), B, H, C, D, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"the other decode_attention failed to launch: CUDA error {rc}")
        return out
    return run


def other_dilated(lib):
    fn = lib.dilated_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                   + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def run(q, k, v, er, dilation, head7_bug=False):
        B, H, T, d = q.shape
        er_t = er.float().transpose(1, 2).contiguous()
        first = (ctypes.c_int * H)(*head_offsets(H, ATTN_LEN)[:, 0].tolist())
        out = torch.empty_like(q)
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), er_t.data_ptr(), out.data_ptr(),
                B, H, T, d, ATTN_LEN, dilation, int(head7_bug and H == 8), first,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"the other dilated_attention failed to launch: CUDA error {rc}")
        return out
    return run


def other_dilated_backward(lib, source: Path):
    """The other checkout's K2b behind this tree's wrapper's steps (der's
    partials summed over batch and tiles), with its launcher's own
    arguments, read by name from its source: the PR 9 design takes 11
    pointers (with a p and a ds scratch [B, H, T, A] f32) and er as
    [H, A, d] f32; the one-launch design 9 pointers and er as it comes,
    [H, d, A] with a dtype flag."""
    text = source.read_text()
    params = re.search(r"int dilated_attention_bwd_launch\(([^)]*)\)", text).group(1)
    names = [re.findall(r"\w+", p)[-1] for p in params.split(",")]
    # Positions per block: kTile, or kThreads where each thread took one query (PR 9).
    tile = int(re.search(r"constexpr int (?:kTile|kThreads) = (\d+);", text).group(1))
    fn = lib.dilated_attention_bwd_launch
    fn.argtypes = [ctypes.POINTER(ctypes.c_int) if n == "first" else
                   ctypes.c_void_p if "*" in p else ctypes.c_int
                   for n, p in zip(names, params.split(","))]
    fn.restype = ctypes.c_int

    def run(q, k, v, er, g, dilation, head7_bug=False):
        B, H, T, d = q.shape
        dq, dk, dv = (torch.empty_like(q) for _ in range(3))
        tiles = -(-T // tile)
        # Partials [B, H, tiles, A, d] in the PR 9 design, [H, A, d, B * tiles] since.
        part = torch.empty((B, H, tiles, ATTN_LEN, d) if "pbuf" in names
                           else (H, ATTN_LEN, d, B * tiles), dtype=torch.float32, device=q.device)
        scratch = torch.empty(2, B, H, T, ATTN_LEN, dtype=torch.float32, device=q.device) \
            if "pbuf" in names else None
        er_in = er.contiguous() if "er_bf16" in names else er.float().transpose(1, 2).contiguous()
        value = {
            "q": q.data_ptr(), "k": k.data_ptr(), "v": v.data_ptr(), "er": er_in.data_ptr(),
            "dout": g.data_ptr(), "dq": dq.data_ptr(), "dk": dk.data_ptr(), "dv": dv.data_ptr(),
            "der_part": part.data_ptr(), "B": B, "H": H, "T": T, "D": d, "A": ATTN_LEN,
            "dilation": dilation, "head7_from6": int(head7_bug and H == 8),
            "er_bf16": int(er_in.dtype == torch.bfloat16),
            "first": (ctypes.c_int * H)(*head_offsets(H, ATTN_LEN)[:, 0].tolist()),
            "stream": torch.cuda.current_stream().cuda_stream,
        }
        if scratch is not None:
            value["pbuf"], value["dsbuf"] = scratch[0].data_ptr(), scratch[1].data_ptr()
        rc = fn(*(value[n] for n in names))
        if rc != 0:
            raise RuntimeError(f"the other dilated_attention_bwd failed to launch: CUDA error {rc}")
        der = part.sum(dim=(0, 2)) if "pbuf" in names else part.sum(dim=3)
        return dq, dk, dv, der.transpose(1, 2)
    return run


def check_backward(name, got, ref):
    """dq, dk, dv within two bf16 ulps of each one's largest |value| (0 for an
    all-zero reference), der within DER_RTOL of its largest |value|; returns
    the largest error."""
    errs = []
    for part, a, r in zip(("dq", "dk", "dv", "der"), got, ref):
        top = r.abs().max().item()
        tol = DER_RTOL * top if part == "der" else (kernel_tolerance(r) if top > 0 else 0.0)
        err = (a.float() - r).abs().max().item()
        if not torch.isfinite(a.float()).all() or err > tol:
            raise RuntimeError(f"{name} {part}: max|kernel - plain| {err:.3g} > {tol:.3g}")
        errs.append(err)
    return max(errs)


def in_turns(other, this, flush):
    """Times of (other, this, this, other); returns both pairs."""
    o1 = time_ms(other, flush=flush)
    t1 = time_ms(this, flush=flush)
    t2 = time_ms(this, flush=flush)
    o2 = time_ms(other, flush=flush)
    return [o1, o2], [t1, t2]


def check(name, out, ref):
    err = (out.float() - ref.float()).abs().max().item()
    tol = kernel_tolerance(ref)
    if not torch.isfinite(out.float()).all() or err > tol:
        raise RuntimeError(f"{name}: max|kernel - plain| {err:.3g} > {tol:.3g}")
    return err


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--other", type=Path, required=True,
                        help="root of another checkout of the repository")
    parser.add_argument("--json", type=Path, default=None, help="also write the rows here")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA device", flush=True)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    _build.build(NAMES)
    libs = build_other(args.other)
    flush, dirty = L2Flush(), L2Flush(dirty=True)
    source = args.other / "etude_tpu_torch" / "csrc" / "dilated_attention_bwd.cu"
    rows = (k1_rows(other_decode(libs["decode_attention"]), flush, dirty)
            + k2_rows(other_dilated(libs["dilated_attention"]), flush, dirty)
            + k2b_rows(other_dilated_backward(libs["dilated_attention_bwd"], source), flush))
    for r in rows:
        if r["kernel"] == "decode_attention":
            shape = f"B={r['B']:2d} C={r['C']:4d}"
        else:
            shape = (f"{'B=%2d ' % r['B'] if r['kernel'] != 'dilated_attention' else ''}"
                     f"T={r['T']:5d} dil={r['dilation']:3d}{' h7' if r['head7_bug'] else ''}")
        extra = f" sdpa {r['library_ms']:.4f}" if "library_ms" in r else ""
        if "dirty_flush_ms" in r:
            extra += "; with a write-only flush " + ", ".join(
                f"{k} {v if isinstance(v, float) else statistics.mean(v):.4f}"
                for k, v in r["dirty_flush_ms"].items())
        print(f"  {r['kernel']:<26s} {shape}: other {r['other_ms'][0]:.4f} / "
              f"{r['other_ms'][1]:.4f}, this {r['this_ms'][0]:.4f} / {r['this_ms'][1]:.4f}, "
              f"bound {r['bound_ms']:.4f}, plain {r['plain_ms']:.4f}{extra} ms", flush=True)

    def means(kernel, **shape):
        sel = [r for r in rows if r["kernel"] == kernel and not r["head7_bug"]
               and all(r[k] == v for k, v in shape.items())]
        if not sel:
            return None
        out = {side: statistics.mean(statistics.mean(r[f"{side}_ms"]) for r in sel)
               for side in ("other", "this")}
        out["bound"] = statistics.mean(r["bound_ms"] for r in sel)
        return out

    summary = {
        "card": smi,
        "dilated_attention_mean_over_dilations_T12288": means("dilated_attention", T=12288),
        "dilated_attention_backward_mean_over_dilations_B40_T512":
            means("dilated_attention_backward", B=40, T=512),
        "dilated_attention_backward_mean_over_dilations_B5_T12288":
            means("dilated_attention_backward", B=5, T=12288),
        "rows": rows,
    }
    print(smi, flush=True)
    print(json.dumps(summary), flush=True)
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(summary, indent=1))
    return 0


def k1_rows(old_k1, flush, dirty):
    rows = []
    for seed, (B, C) in enumerate(K1_SHAPES):
        q, k, v, bias = attention_inputs(B, C, seed)
        ref = decode_attention_plain(q, k, v, bias)
        errs = [check(f"{who} decode_attention B={B} C={C}", fn(q, k, v, bias), ref)
                for who, fn in (("other", old_k1), ("this", decode_attention))]
        calls = (lambda: old_k1(q, k, v, bias), lambda: decode_attention(q, k, v, bias))
        other_ms, this_ms = in_turns(*calls, flush)
        q4, mask = q.to(torch.bfloat16)[:, :, None], bias.to(torch.bfloat16)[:, None, None, :]
        sdpa = lambda: F.scaled_dot_product_attention(q4, k, v, attn_mask=mask)  # noqa: E731
        bound_ms, bound_by, _ = decode_bound(B, k.shape[1], C, k.shape[3])
        if (B, C) == MAIN_K1:
            dirty_ms = dict(zip(("other", "this"), in_turns(*calls, dirty)))
            dirty_ms["library"] = time_ms(sdpa, flush=dirty)
        rows.append({
            "kernel": "decode_attention", "B": B, "C": C, "other_ms": other_ms,
            "this_ms": this_ms, "max_abs_err": errs, "bound_ms": bound_ms,
            "bound_by": bound_by,
            "plain_ms": time_ms(lambda: decode_attention_plain(q, k, v, bias), flush=flush),
            "library_ms": time_ms(sdpa, flush=flush),
        })
        if (B, C) == MAIN_K1:
            rows[-1]["dirty_flush_ms"] = dirty_ms
    return rows


def k2_rows(old_k2, flush, dirty):
    rows = []
    for seed, (T, dil, h7) in enumerate(K2_SHAPES):
        q, k, v, er = dilated_inputs(5, T, 100 + seed)
        ref = dilated_attention_plain(q, k, v, er, dil, head7_bug=h7)
        errs = [check(f"{who} dilated_attention T={T} dilation={dil} head7_bug={h7}",
                      fn(q, k, v, er, dil, head7_bug=h7), ref)
                for who, fn in (("other", old_k2), ("this", dilated_attention))]
        calls = (lambda: old_k2(q, k, v, er, dil, head7_bug=h7),
                 lambda: dilated_attention(q, k, v, er, dil, head7_bug=h7))
        other_ms, this_ms = in_turns(*calls, flush)
        bound_ms, bound_by, _ = dilated_bound(5, q.shape[1], T, q.shape[3])
        rows.append({
            "kernel": "dilated_attention", "B": 5, "T": T, "dilation": dil, "head7_bug": h7,
            "other_ms": other_ms, "this_ms": this_ms, "max_abs_err": errs,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "plain_ms": time_ms(lambda: dilated_attention_plain(q, k, v, er, dil, head7_bug=h7),
                                iters=10, flush=flush),
        })
        if T == 12288 and dil == 1 and not h7:
            rows[-1]["dirty_flush_ms"] = dict(zip(("other", "this"), in_turns(*calls, dirty)))
    return rows


def k2b_rows(old_k2b, flush):
    rows = []
    for seed, (B, T, dil, h7) in enumerate(K2B_SHAPES):
        q, k, v, er = dilated_inputs(B, T, 200 + seed)
        g = torch.randn(q.shape, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(seed)).bfloat16()
        ref = dilated_attention_backward_plain(q, k, v, er, g, dil, head7_bug=h7)
        errs = [check_backward(f"{who} dilated_attention_backward B={B} T={T} dilation={dil} "
                               f"head7_bug={h7}", fn(q, k, v, er, g, dil, head7_bug=h7), ref)
                for who, fn in (("other", old_k2b), ("this", dilated_attention_backward))]
        calls = (lambda: old_k2b(q, k, v, er, g, dil, head7_bug=h7),
                 lambda: dilated_attention_backward(q, k, v, er, g, dil, head7_bug=h7))
        other_ms, this_ms = in_turns(*calls, flush)
        bound_ms, bound_by, _ = dilated_backward_bound(B, q.shape[1], T, q.shape[3])
        rows.append({
            "kernel": "dilated_attention_backward", "B": B, "T": T, "dilation": dil,
            "head7_bug": h7, "other_ms": other_ms, "this_ms": this_ms, "max_abs_err": errs,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "plain_ms": time_ms(lambda: dilated_attention_backward_plain(
                q, k, v, er, g, dil, head7_bug=h7), iters=5, flush=flush),
        })
    return rows


if __name__ == "__main__":
    sys.exit(main())
