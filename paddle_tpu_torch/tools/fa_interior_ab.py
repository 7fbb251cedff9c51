"""What the masked kernels' interior-tile test is worth: K6 and the masked
arms of K2/K3 as built from ``ops/csrc/flash_attention.cu``, against a
build of the same source in which no tile counts as interior, so that
every score of a live tile goes through ``mask_score``.

Times each kernel at Mistral-7B's training shape (B 2, S 8192, 32 query
heads over 8 kv heads, head_dim 128, bf16, causal) under the two band
forms its training paths give it: the 4096-token window, and packed
documents of 128-4096 tokens folded into the window. The two builds run
in the order shipped, variant, variant, shipped. Their bits differ by
rounding alone: an interior tile fuses s * scale * log2(e) - m into one
FMA where a masked tile rounds the product first. So they are held to
each other at ``tools/k6_ab.py``'s tolerance (out and lse as there; dq,
dk and dv at ``tools/k2_k3_ab.py``'s, which ``k6_ab`` builds on), and
the largest difference of each output is printed beside its ratio to
the limit. Prints one line per reading and, last, a JSON object of them
all.

    python -m paddle_tpu_torch.tools.fa_interior_ab [--iters N]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

from paddle_tpu_torch.tools.k2_k3_ab import ratio
from paddle_tpu_torch.tools.k6_ab import LSE_TOL, lse_err, out_sigma, ratios

# tile_flags's `clear` starts true only when the tile could be interior;
# the variant starts it false, so __syncthreads_and never says interior
_CLEAR = "                   mk.add == nullptr && q1 == q0 + BQ"
_NEVER = "                   false && mk.add == nullptr && q1 == q0 + BQ"

B, S, H, HKV, D, WINDOW = 2, 8192, 32, 8, 128, 4096


def variant_library():
    """A KernelLibrary of the source with the interior test off."""
    from paddle_tpu_torch.cuda_build import BUILD_DIR, KernelLibrary
    from paddle_tpu_torch.ops import fa_kernel as FK

    src = FK.KERNEL_LIBRARY.source.read_text()
    if src.count(_CLEAR) != 1:
        raise RuntimeError("tile_flags's interior test not found in "
                           f"{FK.KERNEL_LIBRARY.source}")
    # beside copies of the headers it includes, which resolve relative to it
    out = BUILD_DIR / "no_interior"
    out.mkdir(parents=True, exist_ok=True)
    for header in FK.KERNEL_LIBRARY.sources()[1:]:
        (out / header.name).write_text(header.read_text())
    path = out / "flash_attention.cu"
    path.write_text(src.replace(_CLEAR, _NEVER))
    return KernelLibrary(path, FK.KERNEL_LIBRARY.declare)


def band_cases(dev):
    """(name, (start, end)) of the window and of packed documents folded
    into it: C=1 bands, key j masking the rows from its document's end
    and from j + WINDOW on."""
    import numpy as np
    import torch

    start = torch.clamp(torch.arange(S, dtype=torch.int32) + WINDOW,
                        max=2 ** 31 - 1)[None, None].expand(B, 1, S)
    end = torch.full_like(start, 2 ** 31 - 1)
    rng = np.random.default_rng(3)
    ends = torch.zeros(B, 1, S, dtype=torch.int32)
    for b in range(B):
        lo = 0
        while lo < S:
            n = min(int(rng.integers(128, 4097)), S - lo)
            ends[b, 0, lo:lo + n] = lo + n
            lo += n
    return [("window", (start[:1].to(dev), end[:1].to(dev))),
            ("documents + window", (torch.minimum(ends, start).to(dev),
                                    end.to(dev)))]


def time_kernels(FK, q, k, v, do, fm, iters):
    """({kernel: ms}, outputs) of K6, K2 and K3 on these inputs."""
    import torch

    def ms(fn):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        for _ in range(iters):
            fn()
        t1.record()
        t1.synchronize()
        return t0.elapsed_time(t1) / iters
    kw = dict(causal=True, fm=fm)
    out, lse = FK.fa_forward_masked_cuda(q, k, v, return_lse=True, **kw)
    delta = FK._delta(out, do, None)
    dq = FK.fa_dq_cuda(q, k, v, do, lse, delta, **kw)
    dk, dv = FK.fa_dkv_cuda(q, k, v, do, lse, delta, **kw)
    t = {"K6": ms(lambda: FK.fa_forward_masked_cuda(
             q, k, v, return_lse=True, **kw)),
         "K2": ms(lambda: FK.fa_dq_cuda(q, k, v, do, lse, delta, **kw)),
         "K3": ms(lambda: FK.fa_dkv_cuda(q, k, v, do, lse, delta, **kw))}
    return t, (out, lse, dq, dk, dv)


def agreement(shipped, variant, q, k, v, fm):
    """{output: (ratio to the limit, largest |variant - shipped|)} of the
    two builds' (out, lse, dq, dk, dv); within tolerance at ratio <= 1."""
    res = {"out": (ratios(variant[0], shipped[0],
                          out_sigma(q, k, v, dict(causal=True, fm=fm)))[0],
                   (variant[0].float() - shipped[0].float()).abs().max()
                   .item())}
    e = lse_err(variant[1], shipped[1])
    res["lse"] = (e / LSE_TOL, e)
    for name, a, b in zip(("dq", "dk", "dv"), variant[2:], shipped[2:]):
        res[name] = (ratio(a, b), (a.float() - b.float()).abs().max().item())
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("fa_interior_ab: no CUDA device", file=sys.stderr)
        return 1
    from paddle_tpu_torch.cuda_build import build
    from paddle_tpu_torch.ops import fa_kernel as FK

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    shipped = FK.KERNEL_LIBRARY
    libs = {"shipped": shipped, "no interior": variant_library()}
    build(list(libs.values()))
    g = torch.Generator(device="cuda").manual_seed(7)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(
            torch.bfloat16)
    q, k, v, do = rnd(B, S, H, D), rnd(B, S, HKV, D), rnd(B, S, HKV, D), \
        rnd(B, S, H, D)
    res = {"card": smi, "shape": [B, S, H, HKV, D], "iters": args.iters}
    try:
        for name, fm in band_cases("cuda"):
            runs, outs = [], {}
            for which in ("shipped", "no interior", "no interior",
                          "shipped"):
                FK.KERNEL_LIBRARY = libs[which]
                t, o = time_kernels(FK, q, k, v, do, fm, args.iters)
                runs.append(dict(build=which, ms=t))
                if which in outs:
                    continue
                outs[which] = o
                print(f"{name}: {which}: " + ", ".join(
                    f"{n} {x:.4f} ms" for n, x in t.items()), flush=True)
            agree = agreement(outs["shipped"], outs["no interior"], q, k, v,
                              fm)
            print(f"{name}: no interior against shipped: " + ", ".join(
                f"{n} {r:.3f} of the limit (largest difference {d:.3e})"
                for n, (r, d) in agree.items()), flush=True)
            if max(r for r, _ in agree.values()) > 1.0:
                raise AssertionError(f"{name}: the builds disagree past "
                                     "k6_ab's tolerance")
            mean = {w: {n: sum(r["ms"][n] for r in runs if r["build"] == w)
                        / 2 for n in ("K6", "K2", "K3")}
                    for w in ("shipped", "no interior")}
            print(f"{name}: mean of two runs each, shipped / no interior: "
                  + ", ".join(f"{n} {mean['shipped'][n]:.4f} / "
                              f"{mean['no interior'][n]:.4f} ms"
                              for n in ("K6", "K2", "K3")), flush=True)
            res[name] = dict(runs=runs, mean=mean, agreement={
                n: dict(ratio=r, max_abs_diff=d)
                for n, (r, d) in agree.items()})
    finally:
        FK.KERNEL_LIBRARY = shipped
    print(smi)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
