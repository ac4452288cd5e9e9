"""Where the whole-row attention kernel's time goes: variants of
``csrc/attention.cu`` that each change one thing, timed side by side.

    python -m dist_tpu_torch.tools.attn_variants [--reps N]

Each variant is the shipped source with the text substitutions of
:data:`VARIANTS`, built with nvcc (all at once) into
``dist_tpu_torch/_build/variants/``, loaded with ctypes and launched through
the same C entry points as the shipped kernel:

  shipped          the source as it is
  exp2f            the accurate ``exp2f`` instead of ``ex2.approx``
  branch_per_tile  without the causal mask too, key tiles past L skipped by
                   a branch per tile, as the causal instances skip theirs
  copies_only      the cp.async copies and the store, no arithmetic
  math_only        the arithmetic on whatever shared memory holds, no copies

K1 at the train shape (256, 197, 3 * 768) and K4 at nb = 8 on its first 64
rows, bf16, 12 heads, timed by ``utils.profiling.time_calls`` (CUDA events
around ``--reps`` launches after warm-up), in two rounds. Prints one JSON line per variant and round: the times, the
largest error against the plain version (variants that compute the
function), and the ptxas registers and spill bytes of the ``<64, 208>``
instances. Needs the CUDA card and nvcc.
"""

import argparse
import ctypes
import json
import os
import subprocess

import torch

from dist_tpu_torch.ops import _build
from dist_tpu_torch.ops import attention as att
from dist_tpu_torch.utils.profiling import time_calls

OUT_DIR = os.path.join(_build.BUILD_DIR, "variants")
SHAPE = (256, 197, 12, 64)      # (B, L, heads, head dim): the train step's K1
K4_ROWS, K4_NB = 64, 8          # K4 on the first 64 rows (microbench attn)

_COPIES = ("  copy_rows<HD>(Qs, base, rs, q0, BQ, L);",
           "  cp_async_wait<1>();   // Q and K; V may still be landing")
_MATH = ("  // Q's A fragments as they are (the scale goes into the softmax's exponent)",
         "  cp_async_wait<0>();   // V")
_PV = ("#pragma unroll\n  for (int t = 0; t < NKT; ++t) {\n"
       "    if (!CAUSAL || t * 16 < kend) {",
       "  // O rounded to bf16 through the warp's own Q rows")

# name: [(old, new, count)], each ``old`` found in the source ``count`` times
VARIANTS = {
    "shipped": [],
    "exp2f": [("= fast_exp2(fmaf", "= exp2f(fmaf", 4)],
    "branch_per_tile": [
        ("const int nk = CAUSAL ? (min(L, q0 + BQ) + 15) & ~15 : LP;",
         "const int nk = ((CAUSAL ? min(L, q0 + BQ) : L) + 15) & ~15;", 1),
        ("const int kend = CAUSAL ? min(L, q0w + 16) : LP;",
         "const int kend = CAUSAL ? min(L, q0w + 16) : L;", 1),
        ("!CAUSAL || ", "", 4)],
    "copies_only": [(_MATH[0], "#if 0\n" + _MATH[0], 1),
                    (_MATH[1], "#endif\n" + _MATH[1], 1),
                    (_PV[0], "#if 0\n" + _PV[0], 1),
                    (_PV[1], "#endif\n" + _PV[1], 1)],
    "math_only": [(_COPIES[0], "#if 0\n" + _COPIES[0], 1),
                  (_COPIES[1], _COPIES[1] + "\n#endif", 1),
                  (_MATH[1], "  // " + _MATH[1].strip(), 1)],
}
COMPUTES = ("shipped", "exp2f", "branch_per_tile")


def variant_source(name, source="attention", variants=None):
    """The text of ``csrc/<source>.cu`` with variant ``name``'s
    substitutions (of ``variants``, by default :data:`VARIANTS`); raises if
    an anchor is not found as often as stated."""
    with open(os.path.join(_build.SRC_DIR, f"{source}.cu")) as f:
        src = f.read()
    for old, new, count in (variants or VARIANTS)[name]:
        if src.count(old) != count:
            raise ValueError(f"variant {name}: {old!r} found {src.count(old)} "
                             f"times, not {count}")
        src = src.replace(old, new)
    return src


def build_all(source="attention", variants=None, signatures=None):
    """{name: ctypes library}, every variant of ``csrc/<source>.cu``
    compiled at once (by default this tool's, bound with the attention
    signatures)."""
    os.makedirs(OUT_DIR, exist_ok=True)
    procs = {}
    for name in variants or VARIANTS:
        src = os.path.join(OUT_DIR, f"{source}-{name}.cu")
        with open(src, "w") as f:
            f.write(variant_source(name, source, variants))
        so = os.path.join(OUT_DIR, f"{source}-{name}.so")
        with open(os.path.join(OUT_DIR, f"{source}-{name}.log"), "w") as log:
            procs[name] = (subprocess.Popen(_build.nvcc_command(src, so),
                                            stdout=log,
                                            stderr=subprocess.STDOUT), so)
    libs = {}
    for name, (proc, so) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n"
                               + variant_log(name, source)[-3000:])
        lib = ctypes.CDLL(so)
        for sym, argtypes in (signatures or att._SIGNATURES).items():
            fn = getattr(lib, sym)
            fn.argtypes = argtypes
            fn.restype = (ctypes.c_char_p if sym.endswith("_error_string")
                          else ctypes.c_int)
        libs[name] = lib
    return libs


def variant_log(name, source="attention"):
    """nvcc's output for variant ``name`` of ``csrc/<source>.cu``."""
    with open(os.path.join(OUT_DIR, f"{source}-{name}.log")) as f:
        return f.read()


def _usage(name):
    """ptxas (registers, spill bytes) of the <64, 208> instances."""
    usage = _build.parse_ptxas(variant_log(name))
    return {tag: [(v.get("registers"), v.get("spill_stores", 0)
                   + v.get("spill_loads", 0))
                  for k, v in usage.items() if tag in k]
            for tag in ("attention_qkv_wr_kernelILi64ELi208ELb0E",
                        "attention_rows_wr_kernelILi64ELi208E")}


def _launch(lib, x, heads, nb=0):
    b, l, d3 = x.shape
    out = torch.empty((b, l, d3 // 3), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream().cuda_stream
    args = (x.data_ptr(), out.data_ptr(), b, l, d3 // 3, heads)
    scale = (d3 // 3 // heads) ** -0.5
    route = att.ROUTES.index("whole_row")
    err = (lib.dtt_attention_qkv_rows(*args, nb, scale, 1, route, stream) if nb
           else lib.dtt_attention_qkv(*args, 0, scale, 1, route, stream))
    _build.check(lib, "dtt_attention_error_string", err, "attention variant")
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--reps", type=int, default=50)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("attn_variants: needs the CUDA card")
    libs = build_all()
    b, l, heads, hd = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((b, l, 3 * heads * hd), generator=gen,
                    device="cuda").to(torch.bfloat16)
    rows = x[:K4_ROWS].contiguous()
    want = att.attention_qkv_plain(x, heads)
    device = torch.cuda.get_device_name(0)
    for rnd in range(2):
        for name, lib in libs.items():
            rec = {"variant": name, "round": rnd, "device": device,
                   "k1_ms": time_calls(lambda: _launch(lib, x, heads), "cuda",
                                       args.reps)[1],
                   "k4_nb8_ms": time_calls(
                       lambda: _launch(lib, rows, heads, K4_NB), "cuda",
                       args.reps)[1]}
            if rnd == 0:
                rec["ptxas"] = _usage(name)
                if name in COMPUTES:
                    got = _launch(lib, x, heads)
                    rec["max_abs_err"] = float(
                        (got.float() - want.float()).abs().max())
            print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
