"""paddle_tpu_torch's paged attention (the plain version its CPU path
runs) against paddle_tpu's gather reference AND its Pallas kernel
(``_ragged_attention_kernel``, interpret mode, called directly on the
per-token rows its entry points would build), on the same numpy inputs.

Tolerance: 1e-5 absolute in float32, the JAX package's own; bf16
outputs add one bf16 rounding (rtol 2**-8), since two float32 results a
few ulps apart may round to neighbouring bf16 values. Cases: mixed
decode / prefill-chunk / verify lanes, GQA, a sliding window, int8
pages, padding tokens and padded lanes (finite). The CUDA kernel itself
runs only on the card (``chip_smoke.py`` holds it against the same plain
version).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.serving import attention as JA
from paddle_tpu_torch.serving import attention as TA

ATOL = 1e-5
BF16_RTOL = 2.0 ** -8
# (context_len, query_len): decode lanes, a prefill chunk, a verify burst
MIXED = [(1, 1), (9, 1), (17, 6), (23, 4), (30, 1)]


@pytest.fixture(autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def ragged_case(lanes, *, nh=4, nkv=2, d=8, page_size=4, num_pages=48,
                max_pages=9, pad_tokens=0, pad_lanes=0, seed=0):
    """numpy arrays of a packed batch: each lane's queries are its last
    query_len positions, its keys sit in randomly ordered pages; padded
    lanes have query_len 0 and context 1 on the scratch page."""
    rng = np.random.default_rng(seed)
    n_lanes = len(lanes) + pad_lanes
    kp = rng.standard_normal((num_pages, page_size, nkv, d)).astype(
        np.float32)
    vp = rng.standard_normal((num_pages, page_size, nkv, d)).astype(
        np.float32)
    free = list(rng.permutation(np.arange(1, num_pages)))
    pt = np.zeros((n_lanes, max_pages), np.int32)
    cl = np.ones(n_lanes, np.int32)
    ql = np.zeros(n_lanes, np.int32)
    qoff = np.zeros(n_lanes, np.int32)
    for i, (c, q) in enumerate(lanes):
        n = -(-c // page_size)
        pt[i, :n] = [free.pop() for _ in range(n)]
        cl[i], ql[i], qoff[i] = c, q, c - q
    t = int(ql.sum()) + pad_tokens
    q = rng.standard_normal((t, nh, d)).astype(np.float32)
    return dict(q=q, k=kp, v=vp, pt=pt, cl=cl, ql=ql, qoff=qoff)


def as_jax(c, int8=False):
    k, v = jnp.asarray(c["k"]), jnp.asarray(c["v"])
    if int8:
        k, v = JA.quantize_q8(k), JA.quantize_q8(v)
    return k, v


def as_torch(c, int8=False, dtype=torch.float32):
    k, v = torch.from_numpy(c["k"]), torch.from_numpy(c["v"])
    if int8:
        return TA.quantize_q8(k), TA.quantize_q8(v)
    return k.to(dtype), v.to(dtype)


# the JAX package's ragged entry jitted: one compile a shape, where op by
# op it took seconds
jax_ragged_ref = jax.jit(JA.ragged_paged_attention,
                         static_argnames=("scale", "window", "spmd"))


def jax_ragged(c, int8=False, kernel=False, **kw):
    """The JAX package's ragged entry (its gather reference), or its
    Pallas kernel on the per-token rows that entry builds for it."""
    k, v = as_jax(c, int8)
    q, pt, cl = (jnp.asarray(c[n]) for n in ("q", "pt", "cl"))
    if not kernel:
        out = jax_ragged_ref(
            q, k, v, pt, cl, jnp.asarray(c["ql"]), jnp.asarray(c["qoff"]),
            **kw)
        return np.asarray(out, np.float32)
    lane, pos = JA._token_lanes(jnp.asarray(c["ql"]),
                                jnp.asarray(c["qoff"]), q.shape[0])
    out = JA._ragged_attention_kernel(q, k, v, pt[lane], cl[lane], pos,
                                      **kw)
    return np.asarray(out, np.float32)


def jax_rectangular_kernel(q, k, v, pt, cl, qoff, **kw):
    """The JAX Pallas kernel on the rectangular surface: row b is a lane
    of query_len S (as ``paddle_tpu``'s ``paged_attention`` expands it)."""
    b, s, nh, d = q.shape
    pos = (qoff[:, None] + jnp.arange(s, dtype=jnp.int32)[None]).reshape(-1)
    out = JA._ragged_attention_kernel(
        q.reshape(b * s, nh, d), k, v, jnp.repeat(pt, s, axis=0),
        jnp.repeat(cl, s), pos, **kw)
    return np.asarray(out).reshape(b, s, nh, d)


def torch_ragged(c, int8=False, **kw):
    k, v = as_torch(c, int8)
    return TA.ragged_paged_attention(
        torch.from_numpy(c["q"]), k, v, torch.from_numpy(c["pt"]),
        torch.from_numpy(c["cl"]), torch.from_numpy(c["ql"]),
        torch.from_numpy(c["qoff"]), **kw).numpy()


@pytest.mark.parametrize("nkv", [4, 2, 1])
def test_ragged_mixed_lanes_match_jax_reference(nkv):
    c = ragged_case(MIXED, nkv=nkv, seed=nkv)
    np.testing.assert_allclose(torch_ragged(c, scale=0.35),
                               jax_ragged(c, scale=0.35), atol=ATOL)


@pytest.mark.parametrize("int8", [False, True])
def test_ragged_window_matches_jax_reference(int8):
    c = ragged_case(MIXED, seed=5)
    kw = dict(scale=0.5, window=5)
    np.testing.assert_allclose(torch_ragged(c, int8, **kw),
                               jax_ragged(c, int8, **kw), atol=ATOL)


def test_ragged_matches_jax_pallas_kernel_interpret():
    """Mixed lanes with GQA, padding tokens and padded lanes; the padding
    rows are finite in both and equal where both define them."""
    c = ragged_case(MIXED, pad_tokens=3, pad_lanes=2, seed=7)
    got = torch_ragged(c, scale=0.35)
    want = jax_ragged(c, kernel=True, scale=0.35)
    assert np.isfinite(got).all() and np.isfinite(want).all()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_ragged_int8_window_matches_jax_pallas_kernel():
    c = ragged_case(MIXED, seed=8)
    kw = dict(scale=0.5, window=6)
    np.testing.assert_allclose(
        torch_ragged(c, int8=True, **kw),
        jax_ragged(c, int8=True, kernel=True, **kw), atol=ATOL)


def test_rectangular_matches_jax_reference_and_kernel():
    """paged_attention's [B, S] surface: a prefill chunk row and a
    decode-shaped row padded to S, int8 pages too."""
    rng = np.random.default_rng(9)
    c = ragged_case([(9, 6), (14, 6)], seed=9)
    b, s, nh, d = 2, 6, 4, 8
    q = rng.standard_normal((b, s, nh, d)).astype(np.float32)
    qoff = np.asarray([3, 8], np.int32)
    for int8 in (False, True):
        jk, jv = as_jax(c, int8)
        args = (jnp.asarray(q), jk, jv, jnp.asarray(c["pt"]),
                jnp.asarray(c["cl"]), jnp.asarray(qoff))
        # jitted: one compile, not one an op
        want = np.asarray(jax.jit(JA.paged_attention_ref,
                                  static_argnames="scale")(*args, scale=0.35))
        want_kernel = jax_rectangular_kernel(*args, scale=0.35)
        tk, tv = as_torch(c, int8)
        targs = (torch.from_numpy(q), tk, tv, torch.from_numpy(c["pt"]),
                 torch.from_numpy(c["cl"]), torch.from_numpy(qoff))
        got = TA.paged_attention(*targs, scale=0.35).numpy()
        got_ref = TA.paged_attention_ref(*targs, scale=0.35).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL)
        np.testing.assert_allclose(got, want_kernel, atol=ATOL)
        np.testing.assert_array_equal(got, got_ref)


@pytest.mark.parametrize("kernel", [False, True])
def test_bf16_pages_match_jax(kernel):
    """bf16 q and pages against the JAX gather reference and its Pallas
    kernel in interpret mode."""
    c = ragged_case(MIXED, seed=10)
    bf = {k: (jnp.asarray(c[k], jnp.bfloat16) if k in ("q", "k", "v")
              else jnp.asarray(c[k])) for k in c}
    if kernel:
        lane, pos = JA._token_lanes(bf["ql"], bf["qoff"], bf["q"].shape[0])
        want = JA._ragged_attention_kernel(
            bf["q"], bf["k"], bf["v"], bf["pt"][lane], bf["cl"][lane], pos,
            scale=0.35)
    else:
        want = JA.ragged_paged_attention(
            bf["q"], bf["k"], bf["v"], bf["pt"], bf["cl"], bf["ql"],
            bf["qoff"], scale=0.35)
    as_bf16 = lambda n: torch.from_numpy(  # noqa: E731
        np.asarray(bf[n], np.float32)).bfloat16()
    got = TA.ragged_paged_attention(
        as_bf16("q"), as_bf16("k"), as_bf16("v"),
        torch.from_numpy(c["pt"]), torch.from_numpy(c["cl"]),
        torch.from_numpy(c["ql"]), torch.from_numpy(c["qoff"]),
        scale=0.35)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=ATOL,
                               rtol=BF16_RTOL)


def test_token_lanes_match_jax():
    ql = np.asarray([1, 0, 6, 4, 0], np.int32)
    qoff = np.asarray([4, 0, 2, 19, 0], np.int32)
    lane, pos = JA._token_lanes(jnp.asarray(ql), jnp.asarray(qoff), 14)
    tl, tp = TA._token_lanes(torch.from_numpy(ql), torch.from_numpy(qoff),
                             14)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(lane))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(pos))


def test_quantize_q8_matches_jax_bit_for_bit():
    x = np.random.default_rng(11).standard_normal((5, 3, 2, 16)) * 37.0
    x = x.astype(np.float32)
    jc, js = JA.quantize_q8(jnp.asarray(x))
    tc, ts = TA.quantize_q8(torch.from_numpy(x))
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_cpu_tensors_take_the_plain_version_and_count_it():
    c = ragged_case(MIXED, seed=12)
    TA.reset_stats()
    torch_ragged(c, scale=0.35)
    assert TA.stats == {"kernel_launches": 0, "decode_launches": 0,
                        "tile_launches": 0, "combine_launches": 0,
                        "plain_calls": 1}
    # the rectangular entry takes the plain version on CPU tensors too
    q = torch.from_numpy(c["q"][:2].reshape(2, 1, *c["q"].shape[1:]))
    k, v = as_torch(c)
    TA.paged_attention(q, k, v, torch.from_numpy(c["pt"][:2]),
                       torch.from_numpy(c["cl"][:2]),
                       torch.from_numpy(c["cl"][:2] - 1), scale=0.35)
    assert TA.stats["plain_calls"] == 2
    assert sum(TA.stats.values()) == 2


def test_kernel_wrapper_refuses_cpu_tensors_and_bad_inputs():
    c = ragged_case(MIXED, seed=13)
    k, v = as_torch(c)
    lane, pos = TA._token_lanes(torch.from_numpy(c["ql"]),
                                torch.from_numpy(c["qoff"]),
                                c["q"].shape[0])
    args = [torch.from_numpy(c["q"]), k, v, torch.from_numpy(c["pt"]),
            torch.from_numpy(c["cl"]), pos, lane]
    TA.reset_stats()
    with pytest.raises(ValueError, match="CUDA"):
        TA.ragged_paged_attention_cuda(*args, scale=0.35)
    with pytest.raises(ValueError, match="CUDA"):
        TA.ragged_paged_attention_cuda(*args, scale=0.35, rows=1)
    with pytest.raises(NotImplementedError):
        TA.ragged_paged_attention(
            args[0], k, v, args[3], args[4], torch.from_numpy(c["ql"]),
            torch.from_numpy(c["qoff"]), scale=0.35, spmd=True)
    # a refused call launched nothing and counted nothing
    assert sum(TA.stats.values()) == 0
