"""Old against new in one call: the paged-attention kernels (K5) and the
flash-attention forward (K1) as built from an earlier tree of this
repository, against the ones built from this tree, on the same inputs.

The earlier tree is a directory that holds its ``paddle_tpu_torch/``
(for example ``git archive <commit> | tar -x -C <dir>``, into a directory
that ``.gitignore`` lists); its ``serving/csrc/ragged_paged_attention.cu``
and ``ops/csrc/flash_attention.cu`` are built beside this tree's, one
``nvcc`` per source, all at once. Then, in the order old, new, new, old:

- K5 at the engine's decode shape (8 lanes x 1 token, contexts 37-2047)
  and prefill shape (1 lane x a 256-token chunk at context 1024), for
  LLaMA-2-7B's 32 kv heads and Mistral's GQA 32:8, bf16 pages, on the
  same token rows (the earlier tree's one kernel; this tree's kernels in
  the form the engine's [B, S] call takes), replayed from CUDA graphs so
  that the host's Python is not timed;
- K1 at the LLaMA training shape (B 4, S 2048, H 32, D 128, causal, lse
  on) and at GPT-3 1.3B's (B 8, S 2048, H 16, right-padded rows as
  segment ids, dropout 0.1).

It fails if the two builds' outputs differ past the kernels' own
tolerance (K5: 2e-2 of the element plus 2e-2; K1: the same on out, lse
1e-4 absolute). Prints a line per reading, the card's name and power
limit, and last a JSON object of every reading.

    python -m paddle_tpu_torch.tools.k5_k1_ab --parent DIR [--iters N]
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

TOL = 2e-2       # bf16 outputs: atol = rtol
LSE_TOL = 1e-4   # float32 lse: absolute
ORDER = ("old", "new", "new", "old")


def parent_libraries(parent):
    """KernelLibrary objects of the earlier tree's two sources (its K5
    exports one C function, ``ragged_paged_attention``; its K1 the same
    entries as this tree's)."""
    from paddle_tpu_torch.cuda_build import KernelLibrary
    from paddle_tpu_torch.ops import fa_kernel as FK

    root = Path(parent) / "paddle_tpu_torch"
    p, i = ctypes.c_void_p, ctypes.c_int
    k5 = KernelLibrary(root / "serving" / "csrc" /
                       "ragged_paged_attention.cu",
                       {"ragged_paged_attention": (
                           [p] * 10 + [i] * 7 + [ctypes.c_float, i, i, p],
                           i)})
    k1 = KernelLibrary(root / "ops" / "csrc" / "flash_attention.cu",
                       FK.KERNEL_LIBRARY.declare)
    for lib in (k5, k1):
        if not lib.source.exists():
            raise FileNotFoundError(f"{lib.source} (give --parent the "
                                    "directory of an unpacked tree)")
    return k5, k1


def old_k5(lib, c, scale):
    """The earlier tree's K5 on the case's token rows: one block per
    (token, kv head), as its wrapper launched it."""
    import torch
    q, kp, vp = c["q"], c["k"], c["v"]
    t, nh, d = q.shape
    _, ps, nkv, _ = kp.shape
    out = torch.empty_like(q)
    rc = lib.lib().ragged_paged_attention(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(), None, None,
        c["pt"].data_ptr(), c["cl"].data_ptr(), c["pos"].data_ptr(),
        c["lane"].data_ptr(), out.data_ptr(), t, nh, nkv, d, ps,
        c["pt"].shape[1], 0, float(scale), 1, 1,
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"the earlier K5 failed to launch: {rc}")
    return out


def new_k5(c, rows):
    """This tree's K5 on the same token rows, told the engine's [B, S]
    layout (``rows`` = S), so it takes the form the engine's call takes."""
    from paddle_tpu_torch.serving import attention as A
    return A.ragged_paged_attention_cuda(
        c["q"], c["k"], c["v"], c["pt"], c["cl"], c["pos"], c["lane"],
        scale=c["scale"], rows=rows)


def ratio(a, b, tol):
    """The largest |a - b| / (tol + tol |b|): within tolerance at <= 1."""
    a, b = a.float(), b.float()
    return ((a - b).abs() / (tol + tol * b.abs())).max().item()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="directory of the earlier tree (holds its "
                         "paddle_tpu_torch/)")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("k5_k1_ab: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as CS
    from paddle_tpu_torch.cuda_build import build
    from paddle_tpu_torch.ops import fa_kernel as FK
    from paddle_tpu_torch.serving import attention as A

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    old5, old1 = parent_libraries(args.parent)
    new1 = FK.KERNEL_LIBRARY
    build([old5, old1, A.KERNEL_LIBRARY, new1])
    res = {"card": smi, "parent": str(args.parent), "iters": args.iters}
    bad = []

    # K5: (name, lanes, kv heads, rows of the engine's [B, S] call)
    for name, lanes, nkv, rows in (
            ("K5 decode", [(37, 1), (130, 1), (511, 1), (777, 1),
                           (1024, 1), (1500, 1), (1800, 1), (2047, 1)], 32,
             1),
            ("K5 prefill", [(1024, 256)], 32, 256),
            ("K5 decode GQA 32:8", [(37, 1), (130, 1), (511, 1), (777, 1),
                                    (1024, 1), (1500, 1), (1800, 1),
                                    (2047, 1)], 8, 1),
            ("K5 prefill GQA 32:8", [(1024, 256)], 8, 256)):
        c = CS.make_case(lanes, nh=32, nkv=nkv, dtype=torch.bfloat16,
                         seed=100)
        run = {"old": lambda: old_k5(old5, c, c["scale"]),
               "new": lambda: new_k5(c, rows)}
        ms = [CS.graph_ms(run[w], iters=args.iters) for w in ORDER]
        r = ratio(run["new"](), run["old"](), TOL)
        res[name] = dict(ms=dict(zip(("old 1", "new 1", "new 2", "old 2"),
                                     ms)), ratio=r)
        print(f"{name}: old {ms[0]:.4f}/{ms[3]:.4f} ms, new {ms[1]:.4f}/"
              f"{ms[2]:.4f} ms; outputs within {r:.3f} of the limit",
              flush=True)
        if not r <= 1.0:
            bad.append(name)

    # K1: the LLaMA training shape and GPT's segment + dropout arm
    b, s, h, _, _ = CS.DROPSEG_TRAIN_SHAPE
    gq, gk, gv, _, _ = CS.fa_inputs(*CS.DROPSEG_TRAIN_SHAPE, torch.bfloat16,
                                    seed=102)
    qs, ks = CS.dropseg_segments("padding", b, s, s, 70, "cuda")
    lq, lk, lv, _, _ = CS.fa_inputs(*CS.FA_TRAIN_SHAPE, torch.bfloat16,
                                    seed=100)
    try:
        for name, fn in (
                ("K1 LLaMA", lambda: FK.fa_forward_cuda(
                    lq, lk, lv, causal=True, return_lse=True)),
                ("K1 GPT segments + dropout", lambda: FK.fa_forward_cuda(
                    gq, gk, gv, causal=True, return_lse=True, q_seg=qs,
                    kv_seg=ks, dropout_p=CS.GPT_DROPOUT,
                    seed=CS.DROP_SEED))):
            ms, outs = [], {}
            for w in ORDER:
                FK.KERNEL_LIBRARY = old1 if w == "old" else new1
                ms.append(CS.cuda_ms(fn, iters=max(args.iters // 2, 1)))
                outs[w] = fn()
            (oo, lo), (on, ln) = outs["old"], outs["new"]
            r = max(ratio(on, oo, TOL),
                    (ln - lo).abs().nan_to_num(0.0).max().item() / LSE_TOL)
            res[name] = dict(ms=dict(zip(("old 1", "new 1", "new 2",
                                          "old 2"), ms)), ratio=r)
            print(f"{name}: old {ms[0]:.4f}/{ms[3]:.4f} ms, new "
                  f"{ms[1]:.4f}/{ms[2]:.4f} ms; outputs within {r:.3f} of "
                  "the limit", flush=True)
            if not r <= 1.0:
                bad.append(name)
    finally:
        FK.KERNEL_LIBRARY = new1
    print(smi)
    print(json.dumps(res))
    if bad:
        print(f"k5_k1_ab: the builds disagree: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
