"""Old against new in one call: K7, the weight-only GEMM, as built from an
earlier tree of this repository, against the one built from this tree, on
the same inputs.

The earlier tree is a directory that holds its ``paddle_tpu_torch/``
(for example ``git archive <commit> paddle_tpu_torch | tar -x -C <dir>``,
into a directory that ``.gitignore`` lists). Its wrapper module
``ops/weight_only_kernel.py`` is loaded under another name beside this
tree's, so that each build runs with its own ``plan()`` (the forms, token
tiles and splits of the two trees differ), and its
``ops/csrc/weight_only_gemm.cu`` (with any header it includes) is built
beside this tree's, one ``nvcc`` per source, both at once. Then, in the
order old, new, new, old, K7 is timed from CUDA-graph replays
(``chip_smoke.graph_ms``) at the timed shapes of ``chip_smoke.py``'s
``quant`` phase (LLaMA-2-7B's q/k/v/o, gate/up and down, Mistral-7B's k/v,
GPT-3 1.3B's biased qkv), int8 and int4 per channel, at
``chip_smoke.K7_TIMED_MS`` rows (decode, the verify round, a prefill chunk
and ``generate``'s 4096-row prefill). Both builds' outputs are held to
``chip_smoke.k7_ratio`` against the plain version; the run fails if either
passes 1.

``--probe`` also times this tree's K7 built as its probes (the
``K7_PROBE`` builds of ``weight_only_gemm.cu``, each dropping one part of
a form's work: wrong values, timed only) beside the shipped build, at
LLaMA-2-7B's gate/up and q/k/v/o, int8 and int4: the tile form without
its dequantization, with its ring of loads alone and with x loaded once
(40, 256 and 4096 rows), without its split partials (40 and 256 rows);
the int4 decode form without its conversion (8 rows).

``--sweep`` times this tree's tile form at every token tile (64, 128,
256) and K split that ``plan()`` weighs, at every timed shape and every
row count of ``chip_smoke.K7_MS`` that takes the tile form, int8 and
int4, beside the plan's own pick. ``--fit FILE`` (no card needed) reads
the JSON line of a run with ``--sweep`` and fits ``plan()``'s cost model
to its times: it prints the constants of least squared relative error
and, row by row, the pick of the fitted model and of the shipped one,
each as a share over the fastest time.

Prints a line per reading, the card's name and power limit, and last a
JSON object of every reading.

    python -m paddle_tpu_torch.tools.k7_ab --parent DIR [--iters N] [--probe]
        [--sweep]
    python -m paddle_tpu_torch.tools.k7_ab --fit FILE
"""
from __future__ import annotations

import argparse
import json
import sys
import types
from pathlib import Path

ORDER = ("old", "new", "new", "old")
PROBE_SHAPES = (("llama2_7b gate/up", 4096, 11008),
                ("llama2_7b q/k/v/o", 4096, 4096))
ALGOS = ("weight_only_int8", "weight_only_int4")

# --probe: {K7_PROBE: (variant, rows, algos)}; K7_PROBE as in the source
PROBES = {1: ("tile: no dequantization", (40, 256, 4096), ALGOS),
          3: ("tile: the ring alone", (40, 256, 4096), ALGOS),
          4: ("tile: x loaded once", (40, 256, 4096), ALGOS),
          5: ("tile: no partials", (40, 256), ALGOS),
          2: ("int4 decode: no conversion", (8,), ALGOS[1:])}


def parent_module(parent):
    """The earlier tree's ``ops/weight_only_kernel.py`` as a module of its
    own (its relative import of ``cuda_build`` taken from this tree),
    whose ``KERNEL_LIBRARY`` is that tree's source."""
    path = (Path(parent) / "paddle_tpu_torch" / "ops" /
            "weight_only_kernel.py").resolve()
    if not path.exists():
        raise FileNotFoundError(f"{path} (give --parent the directory of an "
                                "unpacked tree)")
    src = path.read_text().replace("from ..cuda_build import",
                                   "from paddle_tpu_torch.cuda_build import")
    mod = types.ModuleType("k7_parent_weight_only_kernel")
    mod.__file__ = str(path)
    exec(compile(src, str(path), "exec"), mod.__dict__)
    return mod


def probe_libraries(lib):
    """{K7_PROBE: KernelLibrary} of ``lib``'s source built as each probe:
    a file under the build directory that defines ``K7_PROBE`` and
    includes the source."""
    from paddle_tpu_torch.cuda_build import BUILD_DIR, KernelLibrary

    out = BUILD_DIR / "k7_probes"
    out.mkdir(parents=True, exist_ok=True)
    libs = {}
    for n in PROBES:
        path = out / f"{lib.source.stem}_probe{n}.cu"
        path.write_text(f'#define K7_PROBE {n}\n#include "{lib.source}"\n')
        libs[n] = KernelLibrary(path, lib.declare)
    return libs


def time_probes(mod, libs, iters, smi, out):
    """Time ``mod``'s K7 as shipped, as each probe that applies to the
    case, and as shipped again, into ``out[key]``."""
    import torch
    import chip_smoke as CS

    shipped = mod.KERNEL_LIBRARY
    try:
        for name, k, n in PROBE_SHAPES:
            for algo in ALGOS:
                for m in sorted({m for _, ms, _ in PROBES.values()
                                 for m in ms}):
                    variants = [(v, libs[p]) for p, (v, ms, algos)
                                in PROBES.items()
                                if m in ms and algo in algos]
                    if not variants:
                        continue
                    c = CS.k7_case(k, n, m, algo, -1, torch.bfloat16, False,
                                   7, "cuda")
                    row = {}
                    for variant, lib in (("shipped", shipped), *variants,
                                         ("shipped again", shipped)):
                        mod.KERNEL_LIBRARY = lib
                        row[variant] = CS.graph_ms(
                            lambda: mod.weight_only_matmul_cuda(
                                c["x"], c["codes"], c["scale"],
                                int4=c["int4"]), iters_for(m, iters))
                    mod.KERNEL_LIBRARY = shipped
                    key = f"{name} {algo[-4:]} M {m}"
                    out[key] = row
                    print(f"K7 probe {key} [{smi}]: " + ", ".join(
                        f"{v} {t:.4f}" for v, t in row.items()) + " ms",
                        flush=True)
                    del c
    finally:
        mod.KERNEL_LIBRARY = shipped


def sweep(new, iters, smi, out):
    """This tree's tile form at every (token tile, splits) ``plan()``
    weighs, with ``plan()`` patched, beside the plan's own pick; each
    build held to ``k7_ratio``."""
    import torch
    import chip_smoke as CS

    plan = new.plan
    try:
        for name, k, n, _ in CS.K7_TIMED_SHAPES:
            for algo in ALGOS:
                for m in (m for m in CS.K7_MS if m > new.DECODE_MAX_M):
                    c = CS.k7_case(k, n, m, algo, -1, torch.bfloat16, False,
                                   7, "cuda")
                    want = new.weight_only_matmul_plain(
                        c["x"], c["codes"], c["scale"], int4=c["int4"])
                    ms = {}
                    for tn in new._TOKEN_TILES:
                        for splits in new.tile_splits(k):
                            new.plan = lambda *a, p=(1, tn, splits): p
                            fn = lambda: new.weight_only_matmul_cuda(
                                c["x"], c["codes"], c["scale"],
                                int4=c["int4"])
                            got = fn()
                            torch.cuda.synchronize()
                            r = CS.k7_ratio(got, want, None, torch.bfloat16)
                            if not r <= 1.0:
                                raise AssertionError(
                                    f"K7 sweep {name} M {m} tile {tn} "
                                    f"splits {splits}: ratio {r}")
                            ms[f"{tn}/{splits}"] = CS.graph_ms(
                                fn, iters_for(m, iters))
                    new.plan = plan
                    pick = "%d/%d" % plan(m, n, k, torch.bfloat16)[1:]
                    best = min(ms, key=ms.get)
                    key = f"{name} {algo[-4:]} M {m}"
                    out[key] = dict(m=m, n=n, k=k, ms=ms, plan=pick,
                                    best=best)
                    print(f"K7 sweep {key} [{smi}]: plan {pick} "
                          f"{ms[pick]:.4f} ms, best {best} "
                          f"{ms[best]:.4f} ms", flush=True)
                    del c, want
    finally:
        new.plan = plan


def fit(path):
    """Fit ``plan()``'s cost model to the sweep in ``path`` (the last
    line of a run with ``--sweep``): the constants that minimise the
    squared relative error of the modelled time against every timed
    (token tile, splits), then each row's pick by the fitted and by the
    shipped constants, as its time over the row's fastest."""
    import numpy as np
    from paddle_tpu_torch.ops import weight_only_kernel as WK

    rows = json.loads(Path(path).read_text().strip().splitlines()[-1])
    rows = rows.get("sweep", rows)
    tiles = WK._TOKEN_TILES
    a, t = [], []
    for r in rows.values():
        for tile, ms in r["ms"].items():
            tn, splits = map(int, tile.split("/"))
            stages, waves, part, split = WK.tile_terms(r["m"], r["n"], r["k"],
                                                       tn, splits)
            us = ms * 1e3
            a.append([stages * (tn == x) / us for x in tiles]
                     + [waves / us, part / us, split / us])
            t.append(1.0)
    coef = np.linalg.lstsq(np.array(a), np.array(t), rcond=None)[0]
    stage = {tn: float(c) for tn, c in zip(tiles, coef)}
    wave, inv_rate, finish = (float(c) for c in coef[len(tiles):])
    if min(coef) < 0:
        print(f"k7_ab --fit: a negative constant {coef.tolist()}",
              file=sys.stderr)

    def pick(r, consts):
        st, wv, inv, fin = consts
        return "%d/%d" % min(
            ((tn, s) for tn in tiles for s in WK.tile_splits(r["k"])),
            key=lambda p: np.dot(WK.tile_terms(r["m"], r["n"], r["k"], *p),
                                 (st[p[0]], wv, inv, fin)))

    fitted = (stage, wave, inv_rate, finish)
    shipped = (WK._STAGE_US, WK._WAVE_US, 1 / WK._PART_BYTES_PER_US,
               WK._FINISH_US)
    per_tile = ", ".join(f"{tn}: {v:.4g}" for tn, v in stage.items())
    print(f"_STAGE_US = {{{per_tile}}}")
    print(f"_WAVE_US = {wave:.4g}")
    print(f"_PART_BYTES_PER_US = {1 / inv_rate:.4g}")
    print(f"_FINISH_US = {finish:.4g}")
    worst = {"fitted": 1.0, "shipped": 1.0}
    for key, r in rows.items():
        best = min(r["ms"].values())
        line = []
        for what, consts in (("fitted", fitted), ("shipped", shipped)):
            p = pick(r, consts)
            share = r["ms"][p] / best
            worst[what] = max(worst[what], share)
            line.append(f"{what} {p} {share:.3f}")
        print(f"{key}: best {min(r['ms'], key=r['ms'].get)} {best:.4f} ms; "
              + ", ".join(line))
    print(f"worst pick over the fastest: fitted {worst['fitted']:.3f}, "
          f"shipped {worst['shipped']:.3f}")
    return fitted


def timed_cases():
    """(key, k, n, m, algo, bias) at the quant phase's timed shapes."""
    import chip_smoke as CS
    for name, k, n, bias in CS.K7_TIMED_SHAPES:
        for algo in ("weight_only_int8", "weight_only_int4"):
            for m in CS.K7_TIMED_MS:
                yield f"{name} {algo[-4:]} M {m}", k, n, m, algo, bias


def iters_for(m, iters):
    return max(2, iters * 256 // max(m, 256))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent",
                    help="directory of the earlier tree (holds its "
                         "paddle_tpu_torch/)")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--probe", action="store_true",
                    help="also time the decode and tile forms' variants")
    ap.add_argument("--sweep", action="store_true",
                    help="also time the tile form at every token tile and "
                         "split")
    ap.add_argument("--fit", metavar="FILE",
                    help="fit plan()'s cost model to a --sweep run's "
                         "JSON line (no card needed)")
    args = ap.parse_args(argv)
    if args.fit:
        fit(args.fit)
        return 0
    if not args.parent:
        ap.error("--parent is required unless --fit is given")

    import torch
    if not torch.cuda.is_available():
        print("k7_ab: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as CS
    from paddle_tpu_torch.cuda_build import build
    from paddle_tpu_torch.ops import weight_only_kernel as new

    smi = CS.nvidia_smi_line()
    old = parent_module(args.parent)
    probes = probe_libraries(new.KERNEL_LIBRARY) if args.probe else {}
    # one build a library file (two trees' identical sources share one)
    libs = {lib.path: lib for lib in (old.KERNEL_LIBRARY, new.KERNEL_LIBRARY,
                                      *probes.values())}
    build_s = build(list(libs.values()))
    res = {"card": smi, "parent": str(args.parent), "iters": args.iters,
           "build_s": build_s, "ab": {}, "probe": {}, "sweep": {}}
    mods = {"old": old, "new": new}
    bad = []
    for key, k, n, m, algo, bias in timed_cases():
        c = CS.k7_case(k, n, m, algo, -1, torch.bfloat16, bias, 7, "cuda")
        args_ = (c["x"], c["codes"], c["scale"], c["b"])
        want = new.weight_only_matmul_plain(*args_, int4=c["int4"])
        ms, ratio = [], {}
        for w in ORDER:
            fn = mods[w].weight_only_matmul_cuda
            ms.append(CS.graph_ms(lambda: fn(*args_, int4=c["int4"]),
                                  iters_for(m, args.iters)))
            got = fn(*args_, int4=c["int4"])
            torch.cuda.synchronize()
            ratio[w] = CS.k7_ratio(got, want, c["b"], torch.bfloat16)
        res["ab"][key] = dict(zip(("old 1", "new 1", "new 2", "old 2"), ms),
                              old_ratio=ratio["old"], new_ratio=ratio["new"],
                              old_plan=list(old.plan(m, n, k,
                                                     torch.bfloat16)),
                              new_plan=list(new.plan(m, n, k,
                                                     torch.bfloat16)))
        print(f"K7 {key} [{smi}]: old {ms[0]:.4f}/{ms[3]:.4f} ms, new "
              f"{ms[1]:.4f}/{ms[2]:.4f} ms (old/new "
              f"{(ms[0] + ms[3]) / (ms[1] + ms[2]):.2f}x); k7_ratio old "
              f"{ratio['old']:.3f}, new {ratio['new']:.3f}", flush=True)
        if not max(ratio.values()) <= 1.0:
            bad.append(key)
        del c, args_, want
    if args.probe:
        time_probes(new, probes, args.iters, smi, res["probe"])
    if args.sweep:
        sweep(new, args.iters, smi, res["sweep"])
    print(smi)
    print(json.dumps(res))
    if bad:
        print(f"k7_ab: a build is outside k7_ratio: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
