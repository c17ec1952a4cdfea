"""This tree's hand kernels against another checkout's, in one process on
the card.

    python -m etude_tpu_torch.tools.kernel_ab --other DIR [--json PATH]

DIR holds another checkout of the repository (for example the parent
commit, unpacked with `git archive`). Its `etude_tpu_torch/csrc/*.cu` are
built with this tree's nvcc flags and called through ctypes with the
arguments this tree's wrappers pass, so its launchers must take the same
ones (every design so far does). At the shapes of `chip_smoke.py`'s kernels
phase, with L2 flushed, each kernel is first held against its plain version
(two bf16 ulps of the largest |o|), then timed in turns, other, this, this,
other (medians of 50 launches each, `L2Flush` between launches), beside its
bound, its plain version and, for K1, masked `scaled_dot_product_attention`.
At K1's serving shape and K2's dilation 1 both are timed again with the
write-only flush of the earlier timings. One line per shape, the
card's name and power limit, then one JSON object of every row.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

from ..ops import _build
from ..ops.decode_attention import decode_attention, decode_attention_plain
from ..ops.dilated_attention import (
    ATTN_LEN, dilated_attention, dilated_attention_plain, head_offsets,
)
from ..utils.kernel_bench import (
    L2Flush, attention_inputs, decode_bound, dilated_bound, dilated_inputs,
    kernel_tolerance, time_ms,
)

NAMES = ("decode_attention", "dilated_attention")
K1_SHAPES = [(B, C) for B in (1, 16, 27) for C in (769, 1353)] + [(16, 1217)]
MAIN_K1 = (16, 1217)   # the serving shape
K2_SHAPES = ([(2048, 1, False), (2048, 256, False), (10336, 1, False), (10336, 256, False)]
             + [(12288, 2 ** i, False) for i in range(9)] + [(12288, 8, True)])


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
    old_k1, old_k2 = other_decode(libs[NAMES[0]]), other_dilated(libs[NAMES[1]])
    flush, dirty = L2Flush(), L2Flush(dirty=True)
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
    for r in rows:
        shape = (f"B={r['B']:2d} C={r['C']:4d}" if r["kernel"] == "decode_attention" else
                 f"T={r['T']:5d} dil={r['dilation']:3d}{' h7' if r['head7_bug'] else ''}")
        extra = f" sdpa {r['library_ms']:.4f}" if "library_ms" in r else ""
        if "dirty_flush_ms" in r:
            extra += "; with a write-only flush " + ", ".join(
                f"{k} {v if isinstance(v, float) else statistics.mean(v):.4f}"
                for k, v in r["dirty_flush_ms"].items())
        print(f"  {r['kernel']:<17s} {shape}: other {r['other_ms'][0]:.4f} / "
              f"{r['other_ms'][1]:.4f}, this {r['this_ms'][0]:.4f} / {r['this_ms'][1]:.4f}, "
              f"bound {r['bound_ms']:.4f}, plain {r['plain_ms']:.4f}{extra} ms", flush=True)
    k2_main = [r for r in rows if r.get("T") == 12288 and not r["head7_bug"]]
    summary = {
        "card": smi,
        "dilated_attention_mean_over_dilations_T12288": {
            side: statistics.mean(statistics.mean(r[f"{side}_ms"]) for r in k2_main)
            for side in ("other", "this")},
        "rows": rows,
    }
    print(smi, flush=True)
    print(json.dumps(summary), flush=True)
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
