"""paddle_tpu_torch's flash attention (the plain versions its CPU path
runs) against paddle_tpu's Pallas kernels in interpret mode
(``fa_forward`` / ``fa_backward`` of ``ops/pallas/_fa_kernel.py``, 128
blocks) and against ``jax.vjp`` of its differentiable cores, on the same
numpy inputs.

Cases: causal and not, GQA 4:2, head_dim 64, S 256; the lse (the JAX
``[B*H, S, 128]`` lane layout compared as ``lse_l[:, :, 0]``) and the
``dlse`` fold. Tolerance: float32, 1e-5 absolute on outputs and lse,
1e-4 on gradients (sums of 256 products taken in another order). The
CUDA kernels themselves run only on the card (``chip_smoke.py`` holds
them against these plain versions).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops.pallas import _fa_kernel as JK
from paddle_tpu.ops.pallas import flash_attention as JFA
from paddle_tpu_torch.ops import fa_kernel as TK
from paddle_tpu_torch.ops import flash_attention as TFA

ATOL = 1e-5
GRAD_ATOL = 1e-4
# the JAX side's kernels (interpret mode) compiled as one program without
# LLVM's optimisation passes: the same values, a fifth of the compile time
FAST_COMPILE = {"xla_backend_optimization_level": 0}
B, S, H, HKV, D = 1, 256, 4, 2, 64


@pytest.fixture(autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _inputs(seed=0, s=S):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, s, H, D)).astype(np.float32)
    k = rng.standard_normal((B, s, HKV, D)).astype(np.float32)
    v = rng.standard_normal((B, s, HKV, D)).astype(np.float32)
    do = rng.standard_normal((B, s, H, D)).astype(np.float32)
    dlse = rng.standard_normal((B, H, s)).astype(np.float32)
    return q, k, v, do, dlse


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


def _close(got, want, atol, name):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0, err_msg=name)


@pytest.mark.parametrize("causal,with_dlse", [(False, False),
                                              (True, True)])
def test_forward_and_backward_match_the_pallas_kernels(causal, with_dlse):
    q, k, v, do, dlse = _inputs(2)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    jdl = dict(dlse=jnp.asarray(dlse.reshape(B * H, S))) if with_dlse else {}

    def run(a, b_, c, d, **dl):
        o, lse = JK.fa_forward(a, b_, c, causal=causal, return_lse=True,
                               interpret=True)
        return o, lse, JK.fa_backward(a, b_, c, o, lse, d, causal=causal,
                                      interpret=True, **dl)
    jo, jlse, want = jax.jit(run, compiler_options=FAST_COMPILE)(
        jq, jk, jv, jdo, **jdl)
    tq, tk, tv, tdo, tdlse = _t(q, k, v, do, dlse)
    o, lse = TK.fa_forward(tq, tk, tv, causal=causal, return_lse=True)
    _close(o, jo, ATOL, "out")
    _close(lse, np.asarray(jlse)[:, :, 0].reshape(B, H, S), ATOL, "lse")
    got = TK.fa_backward(tq, tk, tv, o, lse, tdo, causal=causal,
                         dlse=tdlse if with_dlse else None)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert tuple(g.shape) == w.shape, name
        _close(g, w, GRAD_ATOL, name)


def test_plain_backward_is_the_vjp_of_the_plain_forward():
    """The closed form from the saved lse equals autograd through the
    oracle, with both cotangents (out and lse) in play."""
    q, k, v, do, dlse = _inputs(3, s=64)
    tq, tk, tv, tdo, tdlse = _t(q, k, v, do, dlse)
    xs = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    out, lse = TK.fa_forward_plain(*xs, causal=True, return_lse=True)
    want = torch.autograd.grad((out, lse), xs, (tdo, tdlse))
    got = TK.fa_backward_plain(tq, tk, tv, out.detach(), lse.detach(), tdo,
                               causal=True, dlse=tdlse)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _close(g, w, GRAD_ATOL, name)


def test_flash_attention_bshd_grads_match_jax_vjp():
    q, k, v, do, _ = _inputs(4)
    jout, vjp = jax.vjp(lambda a, b, c: JFA._flash_core(a, b, c, True,
                                                        None),
                        *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    xs = [x.requires_grad_() for x in _t(q, k, v)]
    out = TFA.flash_attention_bshd(*xs, causal=True)
    out.backward(torch.from_numpy(do))
    _close(out.detach(), jout, ATOL, "out")
    for name, x, w in zip(("dq", "dk", "dv"), xs, want):
        _close(x.grad, w, GRAD_ATOL, name)


def test_flash_core_lse_takes_both_cotangents():
    """Its backward folds dlse (K2/K3's delta - dlse) and equals autograd
    through the oracle ``_attention_ref_lse``."""
    q, k, v, do, dlse = _inputs(5, s=96)
    ref = [x.requires_grad_() for x in _t(q, k, v)]
    want = torch.autograd.grad(TFA._attention_ref_lse(*ref, causal=True),
                               ref, _t(do, dlse))
    xs = [x.requires_grad_() for x in _t(q, k, v)]
    out, lse = TFA.flash_core_lse(*xs, True, None)
    torch.autograd.backward((out, lse), _t(do, dlse))
    for name, x, w in zip(("dq", "dk", "dv"), xs, want):
        _close(x.grad, w, GRAD_ATOL, name)


def test_no_grad_forward_writes_no_lse_and_counts_plain_calls():
    q, k, v, _, _ = _inputs(6, s=64)
    TFA.reset_dispatch_stats()
    with torch.no_grad():
        out = TFA.flash_attention_bshd(*_t(q, k, v), causal=True)
    assert isinstance(out, torch.Tensor) and out.shape == (B, 64, H, D)
    stats = TFA.dispatch_stats()
    assert stats["plain_fwd_calls"] == 1
    assert stats["fwd_launches"] == stats["dq_launches"] == 0


def test_bf16_plain_forward_rounds_the_probabilities_like_the_oracle():
    q, k, v, _, _ = _inputs(7, s=64)
    tq, tk, tv = (x.bfloat16() for x in _t(q, k, v))
    got = TK.fa_forward(tq, tk, tv, causal=True)
    want = JFA._attention_ref(*(jnp.asarray(x, jnp.bfloat16)
                                for x in (q, k, v)), causal=True)
    assert got.dtype == torch.bfloat16
    # one bf16 rounding of outputs a few float32 ulps apart
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=2 ** -7,
                               atol=1e-3)


def test_k1_and_k6_bf16_route_to_the_wgmma_forward():
    """On the source (no compiler here): the tensor-core launcher sends
    K1 (kFwd) and K6 (kStream, in both kArmMask arms: with and without
    segment ids) to the warp-specialised TMA + wgmma forward of
    fa_fwd_sm90.cuh, one body under two kernel names; bf16 at head_dim 64
    and 128 take the tensor-core launcher, float32 and head_dim 256 the
    CUDA-core one; the mma.sync forward and its helpers are gone."""
    import re
    csrc = TK.KERNEL_LIBRARY.source.parent
    src = TK.KERNEL_LIBRARY.source.read_text()
    hdr = (csrc / "fa_fwd_sm90.cuh").read_text()
    assert '#include "fa_fwd_sm90.cuh"' in src
    assert (csrc / "fa_fwd_sm90.cuh") in TK.KERNEL_LIBRARY.sources()
    mma = src[src.index("int launch_mma("):src.index("int launch_arm(")]
    assert re.search(r"which == kFwd\)\s*return launch_wgmma<D, kArm>", mma)
    assert re.search(r"if constexpr \(\(kArm & kArmMask\) && !\(kArm & "
                     r"kArmDrop\)\) \{\s*if \(which == kStream\)\s*return "
                     r"launch_stream_wgmma<D, kArm>\(p, stream\)", mma)
    arm = src[src.index("int launch_arm("):src.index("int dispatch(")]
    for a in ("kArmMask", "kArmMask | kArmSeg"):
        assert f"FA_ARM({a})" in arm, a
    assert "launch_mma<D, A>(p, which, stream)" in arm
    for d in (64, 128):
        assert f"launch_arm<bf16, {d}, true>" in src
    assert "launch_arm<bf16, 256, false>" in src
    # each launcher reaches its own kernel name; both kernels run one body
    for launcher, kernel in (("int launch_wgmma(", "fa_fwd_wgmma_kernel"),
                             ("int launch_stream_wgmma(",
                              "fa_fwd_stream_wgmma_kernel")):
        body = hdr[hdr.index(launcher):]
        assert f"{kernel}<D, kArm>" in body[:body.index("\n}\n")]
        body = hdr[hdr.index(f"{kernel}(const Params p"):]
        assert body[:body.index("\n}\n")].count(
            "fwd_wgmma<D, kArm>(p, &tq, &tk, &tv)") == 1
    body = hdr[hdr.index("void fwd_wgmma("):]
    body = body[:body.index("\n}\n")]
    for needle in ("wgmma_ss_n128", "wgmma_pv<D>", "tma_rows<D>(",
                   "mbar_wait(", "keep_of(", "mask_score<kArm",
                   "tile_parts<kArm", "kTileEnd", "producer_sync()",
                   "head_bands<kArm>", "warp_uniform("):
        assert needle in body, needle
    # the asm lives in the Hopper building blocks K1/K6 share with K2/K3
    sm90 = (csrc / "sm90.cuh").read_text()
    assert '#include "sm90.cuh"' in hdr
    assert "wgmma.mma_async" in sm90 and "cp.async.bulk.tensor" in sm90
    texts = [p.read_text() for p in TK.KERNEL_LIBRARY.sources()]
    for gone in ("fwd_mma", "fa_fwd_stream_mma_kernel", "fa_fwd_mma_kernel",
                 "fwd_mma_smem", "kMmaBQ", "kMmaBK", "kMmaThreads",
                 "mma16816", r"load_a\(", "mma_rows", r"c_to_a\(",
                 r"ld32\(", r"stage\(", r"mma\.sync\.aligned"):
        assert not any(re.search(rf"\b{gone}\b" if gone[-1].isalnum()
                                 else rf"\b{gone}", t) for t in texts), gone


def test_k2_k3_bf16_route_to_the_wgmma_backward_and_no_mma_sync_remains():
    """On the source (no compiler here): the tensor-core launcher sends K2
    (kDq) and K3 (kDkv) to the TMA + wgmma kernels of fa_bwd_sm90.cuh in
    every arm; the mma.sync backward kernels and their shared-memory sizes
    are gone; the new header and the Hopper building blocks it shares with
    K1 and K6 are among the library's sources, so an edit to either
    rebuilds it; K6 (kStream) reaches its wgmma kernel, not the mma.sync
    fwd_mma of before; the tile tests K1, K6, K2 and K3 share live in one
    place."""
    import re
    csrc = TK.KERNEL_LIBRARY.source.parent
    src = TK.KERNEL_LIBRARY.source.read_text()
    hdr = (csrc / "fa_bwd_sm90.cuh").read_text()
    sm90 = (csrc / "sm90.cuh").read_text()
    assert '#include "fa_bwd_sm90.cuh"' in src
    sources = TK.KERNEL_LIBRARY.sources()
    for name in ("fa_bwd_sm90.cuh", "fa_fwd_sm90.cuh", "sm90.cuh"):
        assert (csrc / name) in sources, name
    mma = src[src.index("int launch_mma("):src.index("int launch_arm(")]
    assert re.search(r"which == kDq \|\| which == kDkv\)\s*return "
                     r"launch_bwd_wgmma<D, kArm>\(p, which == kDq, stream\)",
                     mma)
    assert "launch_stream_wgmma<D, kArm>" in mma
    for gone in ("fa_bwd_dq_mma_kernel", "fa_bwd_dkv_mma_kernel",
                 "dq_mma_smem", "dkv_mma_smem", "kMmaBQ3",
                 "fa_fwd_stream_mma_kernel", "fwd_mma", "mma.sync.aligned"):
        assert gone not in src and gone not in hdr, gone
    fwd = (csrc / "fa_fwd_sm90.cuh").read_text()
    assert src.count("int tile_parts(") == 1
    assert "int tile_parts(" not in hdr and "int tile_parts(" not in fwd
    assert hdr.count("tile_parts<kArm, kBwdTile, false>(") == 2
    launch = hdr[hdr.index("int launch_bwd_wgmma("):]
    for kernel in ("fa_bwd_dq_wgmma_kernel", "fa_bwd_dkv_wgmma_kernel"):
        assert f"{kernel}<D, kArm>" in launch
        body = hdr[hdr.index(f"{kernel}(const Params p"):]
        body = body[:body.index("\n}\n")]
        for needle in ("tma_rows<D>(", "mbar_wait(", "wgmma_rows<D>(",
                       "wgmma_pv<D>(", "bwd_prob<kArm", "keep_of(",
                       "producer_regs", "consumer_regs"):
            assert needle in body, (kernel, needle)
    prob = hdr[hdr.index("float bwd_prob("):]
    assert "mask_score<kArm" in prob[:prob.index("\n}\n")]
    assert "tma_load(" in sm90[sm90.index("void tma_rows("):]
    assert "wgmma.mma_async" in sm90 and "cp.async.bulk.tensor" in sm90
    # the helpers live in one place: neither header defines them again
    for helper in ("void mbar_wait(", "void tma_load(", "uint64_t wg_desc(",
                   "bool tensor_map("):
        assert sm90.count(helper) == 1, helper
        assert helper not in hdr and helper not in (
            csrc / "fa_fwd_sm90.cuh").read_text(), helper
