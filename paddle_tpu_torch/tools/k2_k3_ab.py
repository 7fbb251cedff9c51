"""Old against new in one call: the flash-attention backward, K2 (dq) and
K3 (dk, dv), as built from an earlier tree of this repository, against
the ones built from this tree, on the same inputs.

The earlier tree is a directory that holds its ``paddle_tpu_torch/``
(for example ``git archive <commit> paddle_tpu_torch | tar -x -C <dir>``,
into a directory that ``.gitignore`` lists); its
``ops/csrc/flash_attention.cu`` (with the headers it includes) is built
beside this tree's, one ``nvcc`` per source, both at once. Both export
the same C entries. Then, in the order old, new, new, old, K2 and K3 are
timed with CUDA events at three shapes, each from this tree's forward's
lse and ``delta = rowsum(dO * O)``:

- LLaMA-2-7B's training step: B 4, S 2048, H = KV = 32, D 128, causal
  (the plain arm);
- GPT-3 1.3B's: B 8, S 2048, H 16, D 128, causal, right-padded rows as
  segment ids, dropout 0.1 (the segment + dropout arm);
- Mistral-7B's: B 2, S 8192, 32 query over 8 kv heads, D 128, causal,
  the 4096-token window as a FlashMask band (the masked arm).

It fails if the two builds' dq, dk or dv differ past the kernels' bf16
tolerance: |new - old| <= 2e-2 |old| + 2e-2 RMS(old), element by element
(the two builds round p and ds to bf16 at the same places; what differs
is the order of the float32 sums). Prints a line per reading, the card's
name and power limit, and last a JSON object of every reading.

    python -m paddle_tpu_torch.tools.k2_k3_ab --parent DIR [--iters N]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

TOL = 2e-2   # bf16 gradients: of the element and of the tensor's RMS
ORDER = ("old", "new", "new", "old")
NAMES = ("dq", "dk", "dv")


def parent_library(parent):
    """The KernelLibrary of the earlier tree's flash-attention source."""
    from paddle_tpu_torch.cuda_build import KernelLibrary
    from paddle_tpu_torch.ops import fa_kernel as FK

    lib = KernelLibrary(Path(parent) / "paddle_tpu_torch" / "ops" / "csrc" /
                        "flash_attention.cu", FK.KERNEL_LIBRARY.declare)
    if not lib.source.exists():
        raise FileNotFoundError(f"{lib.source} (give --parent the directory "
                                "of an unpacked tree)")
    return lib


def cases():
    """(name, q, k, v, do, keyword arguments of the backward) of the three
    shapes, inputs N(0, 1) from seeds on the card."""
    import torch
    import chip_smoke as CS

    bf16 = torch.bfloat16
    q, k, v, do, _ = CS.fa_inputs(*CS.FA_TRAIN_SHAPE, bf16, seed=100)
    yield "LLaMA plain causal", q, k, v, do, dict(causal=True)
    del q, k, v, do
    b, s = CS.DROPSEG_TRAIN_SHAPE[:2]
    q, k, v, do, _ = CS.fa_inputs(*CS.DROPSEG_TRAIN_SHAPE, bf16, seed=102)
    qs, ks = CS.dropseg_segments("padding", b, s, s, 70, "cuda")
    yield "GPT segments + dropout", q, k, v, do, dict(
        causal=True, q_seg=qs, kv_seg=ks, dropout_p=CS.GPT_DROPOUT,
        seed=CS.DROP_SEED)
    del q, k, v, do
    s = CS.MASKED_TRAIN_SHAPE[1]
    q, k, v, do, _ = CS.fa_inputs(*CS.MASKED_TRAIN_SHAPE, bf16, seed=101)
    yield "Mistral masked window", q, k, v, do, dict(
        causal=True, fm=CS.window_bands(s, CS.MISTRAL_WINDOW, "cuda"))


def forward(q, k, v, kw):
    """out and lse from this tree's forward (K6 under a band, else K1)."""
    from paddle_tpu_torch.ops import fa_kernel as FK
    if kw.get("fm"):
        return FK.fa_forward_masked_cuda(q, k, v, causal=kw["causal"],
                                         return_lse=True, fm=kw["fm"])
    return FK.fa_forward_cuda(q, k, v, return_lse=True, **kw)


def ratio(new, old):
    """The largest |new - old| / (TOL |old| + TOL RMS(old)): within
    tolerance at <= 1."""
    new, old = new.float(), old.float()
    rms = old.square().mean().sqrt()
    return ((new - old).abs() / (TOL * old.abs() + TOL * rms).clamp_min(
        1e-30)).max().item()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="directory of the earlier tree (holds its "
                         "paddle_tpu_torch/)")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("k2_k3_ab: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as CS
    from paddle_tpu_torch.cuda_build import build
    from paddle_tpu_torch.ops import fa_kernel as FK

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    old, new = parent_library(args.parent), FK.KERNEL_LIBRARY
    build([old, new])
    res = {"card": smi, "parent": str(args.parent), "iters": args.iters}
    bad = []
    try:
        for name, q, k, v, do, kw in cases():
            out, lse = forward(q, k, v, kw)
            delta = FK._delta(out, do, None)
            del out
            runs = {"dq": lambda: FK.fa_dq_cuda(q, k, v, do, lse, delta,
                                                **kw),
                    "dkv": lambda: FK.fa_dkv_cuda(q, k, v, do, lse, delta,
                                                  **kw)}
            ms = {key: [] for key in runs}
            grads = {}
            for w in ORDER:
                FK.KERNEL_LIBRARY = old if w == "old" else new
                for key, fn in runs.items():
                    ms[key].append(CS.cuda_ms(fn, iters=args.iters))
                grads[w] = (runs["dq"](), *runs["dkv"]())
            FK.KERNEL_LIBRARY = new
            r = {n: ratio(a, b_) for n, a, b_ in zip(NAMES, grads["new"],
                                                      grads["old"])}
            res[name] = {key: dict(zip(("old 1", "new 1", "new 2", "old 2"),
                                       t)) for key, t in ms.items()}
            res[name]["ratio"] = r
            for key, t in ms.items():
                print(f"{name} {'K2' if key == 'dq' else 'K3'}: old "
                      f"{t[0]:.4f}/{t[3]:.4f} ms, new {t[1]:.4f}/{t[2]:.4f} "
                      "ms", flush=True)
            print(f"{name}: the builds agree within " + ", ".join(
                f"{n} {x:.3f}" for n, x in r.items()) + " of the limit",
                flush=True)
            if not max(r.values()) <= 1.0:
                bad.append(name)
            del q, k, v, do, lse, delta, grads
            torch.cuda.empty_cache()
    finally:
        FK.KERNEL_LIBRARY = new
    print(smi)
    print(json.dumps(res))
    if bad:
        print(f"k2_k3_ab: the builds disagree: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
