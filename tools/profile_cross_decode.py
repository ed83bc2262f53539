#!/usr/bin/env python3
"""Device time of cross_attn_decode against the number of real keys, on
one NVIDIA GPU.

  python3 tools/profile_cross_decode.py [--tree DIR] [--lengths 1,128,480,1152]

At the serving shape (B * H = 256 rows, Li = 1152, Dh = 64, bf16 q), with
random K/V made from a seed, int8 (with per-row scales) and bf16, and every
row's first L keys real: the kernel's device time per call
(torch.profiler, 20 calls) and its largest error against the plain
version. The time at L = 1 is the kernel's fixed cost; the slope is what
each real key's bytes cost. --tree imports plankassembly_tpu_torch from
another checkout (a variant or an earlier commit unpacked beside this one),
so that versions are compared in one run on one card. Needs CUDA.
"""
import argparse
import importlib.util
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=ROOT,
                    help="checkout whose plankassembly_tpu_torch to run")
    ap.add_argument("--lengths", default="1,128,480,1152")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_cross_decode: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.tree))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_helpers", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from plankassembly_tpu_torch.ops import cross_decode as CD

    BH, Li, Dh = 256, 1152, 64
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((BH, Dh), generator=g, device="cuda").bfloat16()
    k32 = torch.randn((BH, Li, Dh), generator=g, device="cuda")
    v32 = torch.randn((BH, Li, Dh), generator=g, device="cuda")
    kq, ks = CD.quantize_rows(k32, (1, 2))
    vq, vs = CD.quantize_rows(v32, (1, 2))
    forms = {"int8": (kq, vq, ks, vs),
             "bf16": (k32.bfloat16(), v32.bfloat16(), None, None)}
    print(f"card: {cs.card_line()}; tree {os.path.abspath(args.tree)}")
    for name, (k, v, ksc, vsc) in forms.items():
        cells = []
        for L in (int(x) for x in args.lengths.split(",")):
            bias = torch.where(torch.arange(Li, device="cuda") < L, 0.0,
                               -1e9).expand(BH, Li).contiguous()

            def call():
                return CD.cross_attn_decode(q, k, v, bias, ksc, vsc,
                                            sm_scale=0.125)

            err = (call() - CD.cross_attn_decode_reference(
                q, k, v, bias, ksc, vsc, sm_scale=0.125)).abs().max().item()
            us = cs.kernel_ms(call, reps=20, warmup=3) * 1e3
            cells.append(f"L={L} {us:.2f} us (err {err:.1e})")
        print(f"K/V {name}: " + "; ".join(cells), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
