"""Time the long route's one-pass kernel against variants of its rounding.

    python -m vtc_tpu_torch.scripts.bench_long_variants

The one-pass kernel of ``csrc/long_attention.cuh`` (bf16, L <= 272: the
ViT-B/16 and ViT-L/14 towers) chains a key tile's Dh/16 k = 16 products of
S in one accumulator from zero and normalises P as e · (1/l), one
reciprocal a row. Each variant here is a copy of ``csrc/`` with those lines
replaced (``VARIANTS``), built by ``nvcc`` under the build directory and
launched through the copy's own ``vtc_fused_mha_long``; ``kept`` is an
unchanged copy built the same way. The port never loads these copies.

For each variant: the ptxas lines of its one-pass instances, the one-ulp
share against ``ops.fused_mha_plain`` (outputs beyond one bf16 ulp at the
median |output|; the limit ``SHARE_LIMIT`` is ``chip_smoke.py``'s) on the
inputs of ``chip_smoke.py`` phase 26 (``CASES``: the same shapes and seeds,
8 inputs, causal and not), and the device time at ``TIMED`` (CUDA-graph
replays over rotating inputs larger than the L2 cache). The last line is
one JSON object of all of it.

It needs a card and raises without one.
"""

from __future__ import annotations

import ctypes
import json
import math
import re
import shutil
import subprocess

import torch

from .. import ops
from ..ops import _build
from ..utils.timing import n_sets, time_ms

SHARE_LIMIT = 1e-4
SEEDS = 8
# (B, L, E, H) of phase 26's one-pass cases, its seeds 1000·L + 10·seed + causal
CASES = {"L129": (16, 129, 768, 12), "L197": (16, 197, 768, 12),
         "L257": (8, 257, 1024, 16), "L272": (4, 272, 512, 8),
         "L257 Dh128": (4, 257, 1024, 8)}
TIMED = {"vit_b16": (64, 197, 768, 12), "vit_l14": (32, 257, 1024, 16),
         "L257 Dh128": (32, 257, 1024, 8)}

_S_CHAINED = ("      sa::mma_bf16(s[j], qf[c], kb[0], kb[1]);\n"
              "      sa::mma_bf16(s[j], qf[c + 1], kb[2], kb[3]);\n")
_S_K8 = ("      add_chunk(s[j], qf[c], kb[0], kb[1]);\n"
         "      add_chunk(s[j], qf[c + 1], kb[2], kb[3]);\n")
_P_RECIP = "const float p[4] = {s[j][0] * i0, s[j][1] * i0, s[j][2] * i1, s[j][3] * i1};"
# e / l rounded to nearest from r = 1/l rounded to nearest: q = e·r, then q
# plus the exact residual (e − q·l)·r
_P_DIV = ("const auto dv = [](float e, float l, float r) {\n"
          "          const float q = e * r;\n"
          "          return fmaf(fmaf(-q, l, e), r, q);\n"
          "        };\n"
          "        const float p[4] = {dv(s[j][0], l0, i0), dv(s[j][1], l0, i0),\n"
          "                            dv(s[j][2], l1, i1), dv(s[j][3], l1, i1)};")
_P_IEEE = "const float p[4] = {s[j][0] / l0, s[j][1] / l0, s[j][2] / l1, s[j][3] / l1};"
# S in one chain a 64 columns, the chains added in fp32 (two at Dh = 128)
_S_TWO_CHAINS = (
    """  for (int j = 0; j < T; ++j) {
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; c += 2) {
      uint32_t kb[4];
      sa::ldsm_x4(kb, k_lane + 8 * j * RS + 16 * c);
""" + _S_CHAINED + """    }
  }
""",
    """  for (int cb = 0; cb < DC / 4; ++cb) {
#pragma unroll
    for (int j = 0; j < T; ++j) {
      float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int c = 4 * cb; c < 4 * cb + 4; c += 2) {
        uint32_t kb[4];
        sa::ldsm_x4(kb, k_lane + 8 * j * RS + 16 * c);
        sa::mma_bf16(t, qf[c], kb[0], kb[1]);
        sa::mma_bf16(t, qf[c + 1], kb[2], kb[3]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = cb == 0 ? t[i] : s[j][i] + t[i];
    }
  }
""")

# name: [(text of long_attention.cuh, its replacement)]
VARIANTS = {
    "kept": [],
    "S k8 sums, e * (1/l)": [(_S_CHAINED, _S_K8)],
    "S k8 sums, e / l (div_rn)": [(_S_CHAINED, _S_K8), (_P_RECIP, _P_DIV)],
    "S k8 sums, IEEE e / l": [(_S_CHAINED, _S_K8), (_P_RECIP, _P_IEEE)],
    "S chained, e / l (div_rn)": [(_P_RECIP, _P_DIV)],
    "S two chains of 4 at Dh = 128, e * (1/l)": [_S_TWO_CHAINS],
}


def patched(text: str, name: str) -> str:
    """``long_attention.cuh``'s ``text`` with variant ``name``'s edits. Raises
    if a text to replace is not there exactly once."""
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: {old!r} is not in long_attention.cuh once")
        text = text.replace(old, new)
    return text


def build(variants=VARIANTS) -> dict:
    """``{name: library path}``: each variant's copy of ``csrc/`` patched and
    compiled, one ``nvcc`` each, all started together. Raises if a text to
    replace is missing or a build fails."""
    root = _build.BUILD_DIR / "long_variants"
    shutil.rmtree(root, ignore_errors=True)
    procs = {}
    for i, name in enumerate(variants):
        d = root / str(i)
        shutil.copytree(_build.CSRC_DIR, d)
        header = d / "long_attention.cuh"
        header.write_text(patched(header.read_text(), name))
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
               str(d / "fused_mha.cu")]
        procs[name] = (d, subprocess.Popen(cmd, stdout=open(d / "log", "w"),
                                           stderr=subprocess.STDOUT))
    for name, (d, proc) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for {name}: see {d / 'log'}")
    return {name: d / "lib.so" for name, (d, _) in procs.items()}


def ptxas_lines(lib) -> list:
    """The one-pass instances' register and spill lines of ``lib``'s build."""
    out, entry = [], None
    for line in (lib.parent / "log").read_text().splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"onepass_kernelILi(\d+)ELi(\d+)E", line)
            entry = f"<{m.group(1)}, {m.group(2)}>" if m else None
        elif entry and ("registers" in line or "spill" in line):
            out.append(f"{entry} {line.split(':', 1)[-1].strip()}")
    return out


def launcher(lib):
    """``fn(q, k, v, heads, causal)`` through ``lib``'s ``vtc_fused_mha_long``
    (the signature of ``ops.attention``'s C entries)."""
    fn = ctypes.CDLL(str(lib)).vtc_fused_mha_long
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 6
                   + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])

    def run(q, k, v, heads: int, causal: bool):
        b, l, e = q.shape
        o = torch.empty((b, l, e), dtype=q.dtype, device=q.device)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0),
                 v.stride(1), b, l, heads, e // heads, int(causal), (e // heads) ** -0.5,
                 1, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{lib}: vtc_fused_mha_long failed with cudaError {err}")
        return o

    return run


def share_beyond_ulp(out, ref) -> float:
    """The share of ``out`` beyond one bf16 ulp at the median |ref|."""
    ulp = 2.0 ** (math.floor(math.log2(ref.float().abs().median().item())) - 7)
    return ((out.float() - ref.float()).abs() > ulp).float().mean().item()


def main() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("bench_long_variants needs an NVIDIA GPU")
    dev = torch.device("cuda")
    libs = build()
    runs = {name: launcher(lib) for name, lib in libs.items()}
    result = {"device": torch.cuda.get_device_name(0), "limit": SHARE_LIMIT, "variants": {}}
    for name, lib in libs.items():
        result["variants"][name] = {"ptxas": ptxas_lines(lib), "shares": {}, "ms": {}}
    for case, (b, l, e, h) in CASES.items():
        for causal in (False, True):
            for seed in range(SEEDS):
                g = torch.Generator(device=dev).manual_seed(1000 * l + 10 * seed + causal)
                q, k, v = torch.randn(b, l, 3 * e, device=dev, generator=g).to(
                    torch.bfloat16).chunk(3, -1)
                ref = ops.fused_mha_plain(q, k, v, h, causal)
                for name, run in runs.items():
                    shares = result["variants"][name]["shares"].setdefault(case, [])
                    shares.append(share_beyond_ulp(run(q, k, v, h, causal), ref))
    g = torch.Generator(device=dev).manual_seed(7)
    for shape, (b, l, e, h) in TIMED.items():
        sets = [torch.randn(b, l, 3 * e, device=dev, generator=g).to(torch.bfloat16).chunk(3, -1)
                for _ in range(n_sets(4 * b * l * e * 2))]
        for name, run in runs.items():
            result["variants"][name]["ms"][shape] = time_ms(
                lambda q, k, v, run=run, h=h: run(q, k, v, h, False), sets)
        del sets
        torch.cuda.empty_cache()
    for name, r in result["variants"].items():
        past = [f"{case} ({sum(s > SHARE_LIMIT for s in shares)} of {len(shares)})"
                for case, shares in r["shares"].items() if max(shares) > SHARE_LIMIT]
        print(f"{name}: " + ", ".join(f"{s} {ms:.5f} ms" for s, ms in r["ms"].items())
              + "; one-ulp share " + ", ".join(
                  f"{case} {min(s):.3g}-{max(s):.3g}" for case, s in r["shares"].items())
              + f"; past {SHARE_LIMIT:g}: {', '.join(past) or 'none'}", flush=True)
        for line in r["ptxas"]:
            print(f"  ptxas {line}", flush=True)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
