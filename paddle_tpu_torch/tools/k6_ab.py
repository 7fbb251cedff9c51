"""Old against new in one call: K6, the streamed masked flash-attention
forward, as built from an earlier tree of this repository, against the
one built from this tree, on the same inputs.

The earlier tree is a directory that holds its ``paddle_tpu_torch/``
(for example ``git archive <commit> paddle_tpu_torch | tar -x -C <dir>``,
into a directory that ``.gitignore`` lists); its
``ops/csrc/flash_attention.cu`` (with the headers it includes) is built
beside this tree's, one ``nvcc`` per source, both at once. Both export
the same C entry, ``fa_forward_stream``. Then, in the order old, new,
new, old, K6 is timed with CUDA events (lse on, as training calls it) at
five cases:

- Mistral-7B's training step: B 2, S 8192, 32 query over 8 kv heads,
  D 128, causal, the 4096-token window as a FlashMask band;
- the same shape with the packed phase's documents folded into the
  window (``chip_smoke.masked_train_cases``);
- ``flash_attn_unpadded``'s cross-length packing (the dropseg phase's
  case (d)): B 1, Sq 1920, Sk 3072, H 16, D 128, non-causal, segment ids;
- the window at head_dim 64 (the masked phase's case (h): B 1, S 4096,
  32 over 8 heads, window 1024, causal);
- the additive mask ``[B, 1, Sq, Sk]`` (case (e): B 2, S 4096, 32 over 8
  heads, D 128, causal, rows and columns of -inf).

It fails if the two builds' out differ past |new - old| <= 2e-2 |old| +
2e-2 RMS(old) + 8 * 2**-8 * sigma, element by element, or their lse past
1e-4 (absolute; a dead row's -inf on both sides). sigma is the root sum
of squares of the products p v summed into the element (float32, from
the plain version's masking): both builds round p to bf16 for P V, but
against running maxima taken over key tiles of other sizes (64 keys
before, 128 now), so an output near 0 whose row has a dominant key moves
by a few bf16 roundoffs of that key's p v between them, as it does
between either build and the plain version (``chip_smoke.fa_limits``
allows each 8). The ratio against the first two terms alone is printed
beside it. Prints a line per reading, the card's name and power limit,
and last a JSON object of every reading.

    python -m paddle_tpu_torch.tools.k6_ab --parent DIR [--iters N]
"""
from __future__ import annotations

import argparse
import json
import sys

from paddle_tpu_torch.tools.k2_k3_ab import ORDER, TOL, parent_library

LSE_TOL = 1e-4
ROUNDOFFS = 8     # bf16 roundoffs of sigma, as chip_smoke.FA_ROUNDOFFS


def cases():
    """(name, q, k, v, keyword arguments of K6) of the five cases, inputs
    N(0, 1) from seeds on the card."""
    import torch
    import chip_smoke as CS

    bf16 = torch.bfloat16
    q, k, v, _, _ = CS.fa_inputs(*CS.MASKED_TRAIN_SHAPE, bf16, seed=101)
    for name, fm in CS.masked_train_cases("cuda"):
        yield name, q, k, v, dict(causal=True, fm=fm)
    del q, k, v
    for name, shape, _, causal, kind in (
            ("(d) cross-length segments", *CS.DROPSEG_CHECKS[5][1:3],
             False, "unpadded"),
            CS.MASKED_CHECKS[8], CS.MASKED_CHECKS[4]):
        b, sq, sk, h, hkv, d = shape
        g = torch.Generator(device="cuda").manual_seed(110)
        q = torch.randn(b, sq, h, d, generator=g, device="cuda").to(bf16)
        k, v = (torch.randn(b, sk, hkv, d, generator=g, device="cuda")
                .to(bf16) for _ in range(2))
        if kind == "unpadded":
            qs, ks = CS.dropseg_segments(kind, b, sq, sk, 0, "cuda")
            kw = dict(causal=causal, q_seg=qs, kv_seg=ks)
        else:
            mask, fm = CS.masked_case(kind, b, sq, sk, h, 110, "cuda")
            kw = dict(causal=causal, mask=mask, fm=fm)
        yield f"{name} {shape}", q, k, v, kw
        del q, k, v


def out_sigma(q, k, v, kw):
    """sigma of each element of out [B, Sq, H, D]: the root sum of squares
    of p v over its row's keys, p from float32 scores under the plain
    version's masking, one batch row at a time (the [1, H, Sq, Sk] scores
    of Mistral's shape are 8.6 GB)."""
    import torch
    from paddle_tpu_torch.ops import fa_kernel as FK

    g = q.shape[2] // k.shape[2]
    sc = q.shape[-1] ** -0.5
    rows = []
    for i in range(q.shape[0]):
        def row(x):
            return x[i:i + 1] if x is not None and x.shape[0] > 1 else x
        s = FK._scores(row(q).float(), FK._repeat_kv(row(k), g).float(), sc,
                       kw.get("causal", False), row(kw.get("mask")),
                       tuple(row(x) for x in kw.get("fm", ())),
                       row(kw.get("q_seg")), row(kw.get("kv_seg")))
        lse = torch.logsumexp(s, dim=-1, keepdim=True)
        p2 = torch.where(torch.isfinite(s), torch.exp(2 * (s - lse)), 0.0)
        del s, lse
        rows.append(torch.einsum("bhqk,bkhd->bqhd", p2, FK._repeat_kv(
            row(v), g).float().square()).sqrt())
        del p2
    return torch.cat(rows)


def ratios(new, old, sigma):
    """(ratio, bare ratio): the largest |new - old| over the limit with
    and without the sigma term; within tolerance at <= 1."""
    new, old = new.float(), old.float()
    d = (new - old).abs()
    base = TOL * old.abs() + TOL * old.square().mean().sqrt()
    return ((d / (base + ROUNDOFFS * 2.0 ** -8 * sigma).clamp_min(1e-30))
            .max().item(), (d / base.clamp_min(1e-30)).max().item())


def lse_err(new, old):
    """The largest |new - old| of two lse tensors, -inf on both sides
    counting 0."""
    import torch
    d = torch.where(new == old, 0.0, (new - old).abs())
    return d.max().item()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="directory of the earlier tree (holds its "
                         "paddle_tpu_torch/)")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("k6_ab: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as CS
    from paddle_tpu_torch.cuda_build import build
    from paddle_tpu_torch.ops import fa_kernel as FK

    smi = CS.nvidia_smi_line()
    old, new = parent_library(args.parent), FK.KERNEL_LIBRARY
    build([old, new])
    res = {"card": smi, "parent": str(args.parent), "iters": args.iters}
    bad = []
    try:
        for name, q, k, v, kw in cases():
            def run():
                return FK.fa_forward_masked_cuda(q, k, v, return_lse=True,
                                                 **kw)
            ms, outs = [], {}
            for w in ORDER:
                FK.KERNEL_LIBRARY = old if w == "old" else new
                ms.append(CS.cuda_ms(run, iters=args.iters))
                outs[w] = run()
            FK.KERNEL_LIBRARY = new
            r, bare = ratios(outs["new"][0], outs["old"][0],
                             out_sigma(q, k, v, kw))
            e = lse_err(outs["new"][1], outs["old"][1])
            res[name] = dict(zip(("old 1", "new 1", "new 2", "old 2"), ms),
                             out_ratio=r, out_ratio_bare=bare, lse_err=e)
            print(f"{name} K6: old {ms[0]:.4f}/{ms[3]:.4f} ms, new "
                  f"{ms[1]:.4f}/{ms[2]:.4f} ms; the builds agree within out "
                  f"{r:.3f} of the limit ({bare:.3f} without the sigma "
                  f"term), lse {e:.2e}", flush=True)
            if not (r <= 1.0 and e <= LSE_TOL):
                bad.append(name)
            del q, k, v, kw, outs
            torch.cuda.empty_cache()
    finally:
        FK.KERNEL_LIBRARY = new
    print(smi)
    print(json.dumps(res))
    if bad:
        print(f"k6_ab: the builds disagree: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
