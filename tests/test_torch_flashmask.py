"""paddle_tpu_torch's masked flash attention (the plain versions its CPU
path runs) against paddle_tpu on the same numpy inputs:

- the plain forward and backward of K6 and the masked arms of K2/K3
  against the Pallas kernels in interpret mode (``fa_forward`` /
  ``fa_backward`` of ``ops/pallas/_fa_kernel.py``, 128 blocks; S 256, H 4
  over 2 kv heads, D 64): FlashMask C=1, C=2 with dead rows, C=4; the
  additive mask in each broadcast form; causal Sq 128 against Sk 256;
- ``flashmask_attention`` and ``flash_attention_bshd(mask=...)`` against
  their JAX namesakes (the CPU reference path there), gradients from
  ``jax.vjp``: the window folds and their compositions, the refusals,
  ``return_softmax_lse`` with both cotangents.

Tolerance: float32, 1e-5 absolute on outputs and lse (a dead row's lse
is -inf on both sides), 1e-4 on gradients (sums of 256 products taken in
another order), as in ``test_torch_flash_attention.py``. The CUDA
kernels themselves run only on the card (``chip_smoke.py`` holds them
against these plain versions).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.core.tensor import Tensor
from paddle_tpu.ops.pallas import _fa_kernel as JK
from paddle_tpu.ops.pallas import flash_attention as JFA
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops import fa_kernel as TK
from paddle_tpu_torch.ops import flash_attention as TFA

ATOL = 1e-5
GRAD_ATOL = 1e-4
# the JAX side's kernels (interpret mode) compiled as one program without
# LLVM's optimisation passes: the same values, a fifth of the compile time
FAST_COMPILE = {"xla_backend_optimization_level": 0}
S, H, HKV, D = 256, 4, 2, 64
IMAX = 2 ** 31 - 1


@pytest.fixture(autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _inputs(seed, b=1, sq=S, sk=S, h=H, hkv=HKV, d=D):
    rng = np.random.default_rng(seed)

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    return r(b, sq, h, d), r(b, sk, hkv, d), r(b, sk, hkv, d), \
        r(b, sq, h, d), r(b, h, sq)


def _close(got, want, atol, name):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert np.array_equal(np.isneginf(got), np.isneginf(want)), name
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=atol, rtol=0,
                               err_msg=name)


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def _kernel_case(name):
    """(inputs, causal, mask, fm) of one kernel-parity case."""
    rng = np.random.default_rng(40)
    if name == "C=1 packed documents":
        # two batch rows packed with documents: key j masks the rows at
        # and after its document's end
        ends = np.zeros((1, 1, S), np.int32)
        for lo, hi in zip((0, 96, 200), (96, 200, S)):
            ends[0, 0, lo:hi] = hi
        return _inputs(1), True, None, (ends, np.full_like(ends, IMAX))
    if name == "C=2 per head, dead rows":
        start = rng.integers(0, S, (1, H, S)).astype(np.int32)
        end = (start + rng.integers(0, 90, (1, H, S))).astype(np.int32)
        start[:, :, :10], end[:, :, :10] = 0, 10   # rows 0..9 see nothing
        return _inputs(2), True, None, (start, end)
    if name == "C=4 two bands":
        # the bands share their batch/head dims (the JAX kernel maps every
        # band through the first band's rows)
        lts = rng.integers(1, 200, (1, H, S)).astype(np.int32)
        lte = lts + rng.integers(1, 40, (1, H, S)).astype(np.int32)
        uts = rng.integers(200, 250, (1, H, S)).astype(np.int32)
        ute = uts + rng.integers(1, 6, (1, H, S)).astype(np.int32)
        return _inputs(3), False, None, (lts, lte, uts, ute)
    if name.startswith("mask "):
        mb, mh = (int(c) for c in name[len("mask "):].split("x"))
        mb, mh = (2 if mb else 1), (H if mh else 1)
        m = rng.standard_normal((mb, mh, S, S)).astype(np.float32)
        m[..., 7:11, :] = -np.inf       # dead rows
        m[..., :, 100:140] = -np.inf
        return _inputs(4, b=2), True, m, ()
    assert name == "causal Sq 128 Sk 256"
    return _inputs(5, sq=128), True, None, ()


KERNEL_CASES = ["C=1 packed documents", "C=2 per head, dead rows",
                "C=4 two bands", "mask 0x0", "mask 1x0", "mask 0x1",
                "mask 1x1", "causal Sq 128 Sk 256"]


@pytest.mark.parametrize("name", KERNEL_CASES)
def test_plain_masked_kernels_match_the_pallas_kernels(name):
    (q, k, v, do, dlse), causal, mask, fm = _kernel_case(name)
    b, sq, h = q.shape[:3]
    jfm = dict(zip(("fm_start", "fm_end", "fm_start2", "fm_end2"),
                   (jnp.asarray(x) for x in fm)))
    if mask is not None:
        jfm["mask"] = jnp.asarray(mask)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))

    def run(a, b_, c, d, dl, **arrs):
        o, lse = JK.fa_forward(a, b_, c, causal=causal, return_lse=True,
                               interpret=True, **arrs)
        return o, lse, JK.fa_backward(a, b_, c, o, lse, d, causal=causal,
                                      interpret=True, dlse=dl, **arrs)
    jo, jlse, want = jax.jit(run, compiler_options=FAST_COMPILE)(
        jq, jk, jv, jdo, jnp.asarray(dlse.reshape(b * h, sq)), **jfm)
    tfm = dict(zip(("fm_start", "fm_end", "fm_start2", "fm_end2"),
                   (_t(x) for x in fm)))
    TK.reset_stats()
    o, lse = TK.fa_forward(_t(q), _t(k), _t(v), causal=causal,
                           return_lse=True, mask=_t(mask), **tfm)
    _close(o, jo, ATOL, "out")
    _close(lse, np.asarray(jlse)[:, :, 0].reshape(b, h, sq), ATOL, "lse")
    got = TK.fa_backward(_t(q), _t(k), _t(v), o, lse, _t(do), causal=causal,
                         dlse=_t(dlse), mask=_t(mask), **tfm)
    for gname, g, w in zip(("dq", "dk", "dv"), got, want):
        assert tuple(g.shape) == w.shape, gname
        _close(g, w, GRAD_ATOL, gname)
    assert TK.stats["plain_fwd_calls"] == TK.stats["plain_bwd_calls"] == 1
    assert TK.stats["stream_fwd_launches"] == 0


def test_dead_rows_give_zero_output_minus_inf_lse_and_zero_grads():
    (q, k, v, do, dlse), causal, _, fm = _kernel_case(
        "C=2 per head, dead rows")
    tfm = dict(zip(("fm_start", "fm_end"), (_t(x) for x in fm)))
    o, lse = TK.fa_forward(_t(q), _t(k), _t(v), causal=causal,
                           return_lse=True, **tfm)
    dq, _, _ = TK.fa_backward(_t(q), _t(k), _t(v), o, lse, _t(do),
                              causal=causal, dlse=_t(dlse), **tfm)
    dead = torch.isneginf(lse)                  # [B, H, S]
    assert dead[:, :, :10].all() and not dead[:, :, 10:].any()
    assert (o.transpose(1, 2)[dead] == 0).all()
    assert (dq.transpose(1, 2)[dead] == 0).all()


# -- the public functions against their JAX namesakes --------------------------

def _idx(kind, b, h, s):
    """startend_row_indices [b, h, s, C] of one kind, from a seed."""
    rng = np.random.default_rng(7)
    if kind == "C1":
        ends = np.full((b, 1, s, 1), s, np.int32)
        ends[:, 0, : s // 3, 0] = s // 3
        ends[:, 0, s // 3: 3 * s // 4, 0] = 3 * s // 4
        return ends
    if kind == "C2":
        st = rng.integers(0, s, (b, h, s, 1))
        return np.concatenate([st, st + rng.integers(0, s // 3, st.shape)],
                              -1).astype(np.int32)
    lts = rng.integers(1, s - 20, (b, 1, s, 1))
    uts = rng.integers(s - 20, s - 4, (b, 1, s, 1))
    return np.concatenate([lts, lts + rng.integers(1, 9, lts.shape), uts,
                           uts + 3], -1).astype(np.int32)


FM_CASES = [  # (id, index kind, window_size, causal, sq, sk)
    ("window", None, 9, True, 64, 64),
    ("window tuple, GQA cross-length", None, (5, 0), True, 32, 64),
    ("window sentinel -1", None, -1, True, 64, 64),
    ("C1 documents", "C1", None, True, 64, 64),
    ("C1 + window: min-start fold", "C1", 7, True, 64, 64),
    ("C2 per-head band", "C2", None, True, 64, 64),
    ("C2 + window: the C=4 form", "C2", 5, True, 64, 64),
    ("C4 bidirectional", "C4", None, False, 64, 64),
]


def _jax_vjp(f, xs, ct):
    """``f(*xs)`` and the cotangents of xs for ``ct``, by ``jax.vjp``,
    compiled as one program (cheaper here than op by op)."""
    def run(a, b_, c, ct_):
        out, vjp = jax.vjp(f, a, b_, c)
        return out, vjp(ct_)
    return jax.jit(run, compiler_options=FAST_COMPILE)(
        *map(jnp.asarray, xs), ct)


def _jax_fmattn(q, k, v, idx, ct, **kw):
    def f(a, b_, c):
        out = JFA.flashmask_attention(
            Tensor(a), Tensor(b_), Tensor(c),
            startend_row_indices=None if idx is None else
            Tensor(jnp.asarray(idx)), **kw)
        if isinstance(out, tuple):
            return tuple(x._data for x in out)
        return out._data
    return _jax_vjp(f, (q, k, v), ct)


@pytest.mark.parametrize("case", FM_CASES, ids=[c[0] for c in FM_CASES])
def test_flashmask_attention_matches_jax_with_grads(case):
    _, kind, window, causal, sq, sk = case
    q, k, v, do, _ = _inputs(11, b=2, sq=sq, sk=sk, d=16)
    idx = None if kind is None else _idx(kind, 2, H, sk)
    kw = dict(window_size=window, causal=causal)
    jout, want = _jax_fmattn(q, k, v, idx, jnp.asarray(do), **kw)
    xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = TF.flashmask_attention(*xs, startend_row_indices=_t(idx), **kw)
    out.backward(torch.from_numpy(do))
    _close(out.detach(), jout, ATOL, "out")
    for name, x, w in zip(("dq", "dk", "dv"), xs, want):
        _close(x.grad, w, GRAD_ATOL, name)


def test_flashmask_return_softmax_lse_takes_both_cotangents():
    q, k, v, do, dlse = _inputs(12, b=2, sq=64, sk=64, d=16)
    idx = _idx("C2", 2, H, 64)
    kw = dict(window_size=11, causal=True, return_softmax_lse=True)
    (jout, jlse), want = _jax_fmattn(
        q, k, v, idx, (jnp.asarray(do), jnp.asarray(dlse)), **kw)
    xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out, lse = TF.flashmask_attention(*xs, startend_row_indices=_t(idx),
                                      **kw)
    torch.autograd.backward((out, lse), (_t(do), _t(dlse)))
    _close(out.detach(), jout, ATOL, "out")
    _close(lse.detach(), jlse, ATOL, "lse")
    for name, x, w in zip(("dq", "dk", "dv"), xs, want):
        _close(x.grad, w, GRAD_ATOL, name)


MASK_CASES = [  # (id, mask shape, bool, sq, sk)
    ("bool [Sq, Sk]", (64, 64), True, 64, 64),
    ("additive [B, 1, Sq, Sk]", (2, 1, 64, 64), False, 64, 64),
    ("additive [1, H, Sq, Sk] cross-length", (1, H, 32, 64), False, 32, 64),
    ("additive [B, Sq, Sk]", (2, 64, 64), False, 64, 64),
    ("additive [B, 1, 1, Sk], not materialised", (2, 1, 1, 64), False, 64,
     64),
]


@pytest.mark.parametrize("case", MASK_CASES, ids=[c[0] for c in MASK_CASES])
def test_flash_attention_bshd_mask_matches_jax_with_grads(case):
    _, shape, is_bool, sq, sk = case
    q, k, v, do, _ = _inputs(13, b=2, sq=sq, sk=sk, d=16)
    rng = np.random.default_rng(14)
    if is_bool:
        mask = rng.random(shape) > 0.3
        mask[np.arange(min(shape)), np.arange(min(shape))] = True
    else:
        mask = rng.standard_normal(shape).astype(np.float32)
        mask[..., : shape[-1] // 4] = -np.inf   # the first keys masked

    def f(a, b_, c):
        return JFA.flash_attention_bshd(Tensor(a), Tensor(b_), Tensor(c),
                                        mask=Tensor(jnp.asarray(mask)),
                                        causal=True)._data
    jout, want = _jax_vjp(f, (q, k, v), jnp.asarray(do))
    xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = TFA.flash_attention_bshd(*xs, mask=_t(mask), causal=True)
    out.backward(torch.from_numpy(do))
    _close(out.detach(), jout, ATOL, "out")
    for name, x, w in zip(("dq", "dk", "dv"), xs, want):
        _close(x.grad, w, GRAD_ATOL, name)


def test_refusals_match_the_reference():
    q = torch.randn(1, 32, 4, 16)
    c4 = _t(_idx("C4", 1, 1, 32))
    with pytest.raises(NotImplementedError, match="two bands"):
        TF.flashmask_attention(q, q, q, startend_row_indices=c4,
                               window_size=3)
    with pytest.raises(NotImplementedError, match="causal=True"):
        TF.flashmask_attention(q, q, q, window_size=3, causal=False)
    with pytest.raises(ValueError, match="batch/head"):
        TF.flashmask_attention(q, q, q,
                               startend_row_indices=_t(_idx("C1", 3, 1, 32)))
    with pytest.raises(ValueError, match=r"\[B, H\|1, Sk, 1\|2\|4\]"):
        TF.flashmask_attention(q, q, q, startend_row_indices=torch.zeros(
            1, 1, 32, 3, dtype=torch.int32))
    band = torch.zeros(1, 1, 32, dtype=torch.int32)
    for kw in (dict(fm_start=band), dict(fm_end=band),
               dict(fm_start=band, fm_end=band, fm_start2=band)):
        with pytest.raises(ValueError, match="paired"):
            TK.fa_forward(q, q, q, causal=True, **kw)
    with pytest.raises(ValueError, match="requires band 1"):
        TK.fa_backward(q, q, q, q, torch.zeros(1, 4, 32), q,
                       fm_start2=band, fm_end2=band)


def test_segment_and_dropout_arms_raise():
    """The bool key-padding mask runs as segment ids (keys 0 / -2, never a
    dense mask) and bshd's dropout as the counter hash; FlashMask's
    dropout, which the kernels' dropout arms do not take, runs the dense
    route at ``seed=`` (which it needs), with the window's bands and the
    kernels' counter hash; ``fixed_seed_offset`` / ``rng_name`` raise
    before anything runs."""
    q = torch.randn(1, 32, 4, 16)
    pad = torch.ones(1, 1, 1, 32, dtype=torch.bool)
    pad[..., 20:] = False
    TK.reset_stats()
    _close(TFA.flash_attention_bshd(q, q, q, mask=pad, causal=True),
           TFA._attention_ref(q, q, q, mask=pad, causal=True), ATOL, "pad")
    _close(TFA.flash_attention_bshd(q, q, q, causal=True, dropout_p=0.1,
                                    seed=3),
           TFA._attention_ref_hash_dropout(q, q, q, 3, 0.1, causal=True),
           ATOL, "dropout")
    assert TK.stats["plain_fwd_calls"] == 2
    for kw in (dict(fixed_seed_offset=torch.zeros(2)),
               dict(rng_name="local_seed")):
        with pytest.raises(NotImplementedError, match="seed="):
            TF.flashmask_attention(q, q, q, window_size=3, dropout=0.1,
                                   seed=1, **kw)
    with pytest.raises(ValueError, match="seed="):
        TF.flashmask_attention(q, q, q, window_size=3, dropout=0.1)
    assert TK.stats["plain_fwd_calls"] == 2
    dense0 = TFA.stats["dense"]
    got = TF.flashmask_attention(q, q, q, window_size=3, dropout=0.1, seed=9)
    assert TFA.stats["dense"] == dense0 + 1
    win = torch.ones(32, 32, dtype=torch.bool).tril().triu(-3)
    _close(got, TFA.dense_attention(q, q, q, mask=torch.where(
        win, 0.0, float("-inf")), dropout_p=0.1, seed=9), 0.0,
        "flashmask dropout against the window as a dense mask")
    # without training, flashmask_attention's dropout is off, as in JAX
    out = TF.flashmask_attention(q, q, q, window_size=3, dropout=0.1,
                                 training=False)
    assert out.shape == q.shape


# -- the dense oracles (the JAX package's _fm_dense_mask, _fm_ref and
# _fm_ref_lse), held against the plain K6 -----------------------------------

def _fm_dense_mask(fm_start, fm_end, sq, fm_start2=None, fm_end2=None):
    """Dense additive oracle of the column bounds (``[B|1, H|1, Sk]`` →
    ``[B|1, H|1, Sq, Sk]`` 0 / -inf); the optional second band is the C=4
    form."""
    rows = torch.arange(sq, device=fm_start.device)[None, None, :, None]
    dead = (rows >= fm_start[:, :, None, :]) & (rows < fm_end[:, :, None, :])
    if fm_start2 is not None:
        dead = dead | ((rows >= fm_start2[:, :, None, :])
                       & (rows < fm_end2[:, :, None, :]))
    return torch.zeros(dead.shape, dtype=torch.float32,
                       device=dead.device).masked_fill(dead, float("-inf"))


def _fm_causal_mask(fm, sq, sk, causal):
    """The dense additive slab of the bounds with causal folded in."""
    m = _fm_dense_mask(fm[0], fm[1], sq, fm[2], fm[3])
    if causal:
        keep = torch.ones(sq, sk, dtype=torch.bool,
                          device=m.device).tril(sk - sq)
        m = m.masked_fill(~keep, float("-inf"))
    return m


def _fm_ref(q, k, v, fm_start, fm_end, fm_start2, fm_end2, causal, scale):
    """Plain FlashMask attention through the dense mask: a row with no
    live key gives 0 (it runs unmasked and is selected out, so its
    gradient is 0, not NaN)."""
    sq, sk = q.shape[1], k.shape[1]
    m = _fm_causal_mask((fm_start, fm_end, fm_start2, fm_end2), sq, sk,
                        causal)
    dead_row = (~torch.isfinite(m)).all(-1)          # [B|1, H|1, Sq]
    m_safe = m.masked_fill(dead_row[..., None], 0.0)
    out = TFA._attention_ref(q, k, v, mask=m_safe, causal=False, scale=scale)
    return out.masked_fill(dead_row.transpose(1, 2)[..., None], 0.0)


def _fm_ref_lse(q, k, v, fm, causal, scale):
    """``(out, lse)`` of :func:`_fm_ref`, a dead row's lse -inf."""
    sq, sk = q.shape[1], k.shape[1]
    m = _fm_causal_mask(fm, sq, sk, causal)
    dead_row = (~torch.isfinite(m)).all(-1)
    m_safe = m.masked_fill(dead_row[..., None], 0.0)
    out, lse = TFA._attention_ref_lse(q, k, v, causal=False, scale=scale,
                                      mask=m_safe)
    out = out.masked_fill(dead_row.transpose(1, 2)[..., None], 0.0)
    return out, lse.masked_fill(dead_row, float("-inf"))


def test_fm_oracles_agree_with_the_plain_kernels():
    """``_fm_ref`` / ``_fm_ref_lse`` (dense masks, dead rows selected out)
    and the plain K6 with bands compute one function; through the dense
    oracle a dead row's gradient is 0, not NaN."""
    q, k, v, do, _ = _inputs(15, sq=48, sk=48, d=16)
    start = np.zeros((1, 1, 48), np.int32)
    end = np.full((1, 1, 48), 6, np.int32)       # rows 0..5 dead
    fm = (_t(start), _t(end), None, None)
    xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    ref = _fm_ref(*xs, *fm, True, None)
    ref.backward(_t(do))
    ref_out, ref_lse = _fm_ref_lse(*(x.detach() for x in xs), fm, True,
                                   None)
    got, lse = TFA.flash_core_fm_lse(*(x.detach() for x in xs), *fm, True,
                                     None)
    _close(ref.detach(), ref_out, ATOL, "oracles")
    _close(got, ref_out, ATOL, "out")
    _close(lse, ref_lse, ATOL, "lse")
    assert all(torch.isfinite(x.grad).all() for x in xs)
    assert (xs[0].grad[:, :6] == 0).all()


def test_chip_smoke_band_keep_keeps_what_the_plain_masking_keeps():
    """``chip_smoke.band_keep``, from which the card run counts the live
    (row, key) pairs of K6's bound on the packed documents folded into
    the window (and SDPA's bool mask there), keeps exactly the pairs the
    plain masking leaves finite: the window alone and documents folded
    into it, causal, S 512."""
    import chip_smoke as CS
    s, window = 512, 128
    start, end = CS.window_bands(s, window, "cpu")
    rng = np.random.default_rng(3)
    ends = CS.doc_ends([CS.doc_lengths(rng, s, 16, 128) for _ in range(2)],
                       s, "cpu")
    for fm in ((start, end), (torch.minimum(ends, start), end)):
        keep = CS.band_keep(fm, s)
        want = torch.isfinite(TK.masked_scores(
            torch.zeros(keep.shape[0], 1, s, s), causal=True, fm=fm))
        assert keep.shape == want.shape and torch.equal(keep, want)
        assert 0 < int(keep.sum()) < keep.shape[0] * s * (s + 1) // 2
