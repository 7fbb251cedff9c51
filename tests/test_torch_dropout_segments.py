"""paddle_tpu_torch's segment-id and counter-hash dropout arms (the plain
versions its CPU path runs) against paddle_tpu on the same numpy inputs:

- ``fa_kernel.keep_scale`` equals the TPU kernels' ``_keep_scale`` bit
  for bit over seeds (0 and 2**31 - 2 among them), flat heads, p and
  tiles at nonzero offsets;
- the plain forward and backward with segment ids, dropout and GQA
  against the Pallas kernels in interpret mode (``fa_forward`` /
  ``fa_backward`` of ``ops/pallas/_fa_kernel.py``, S 256, H 4 over 2 kv
  heads, D 64) and against ``_attention_ref_hash_dropout``, with a row
  that sees no key;
- ``flash_attention_bshd`` with a bool key-padding mask against its JAX
  namesake (the reference path there), with dropout against the JAX
  kernel-dropout path in interpret mode at the seed that path drew;
- ``flash_attn_unpadded``, self-attention causal and cross-length,
  against the JAX package's kernel path in interpret mode, with
  gradients;
- ``flash_attention``'s dropout at the caller's seed (none given raises),
  and ``dropout``'s modes and ``axis``.

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
from paddle_tpu.nn.functional import flash_attention as JNF
from paddle_tpu.ops.pallas import _fa_kernel as JK
from paddle_tpu.ops.pallas import flash_attention as JFA
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops import fa_kernel as TK
from paddle_tpu_torch.ops import flash_attention as TFA

ATOL = 1e-5
GRAD_ATOL = 1e-4
S, H, HKV, D = 256, 4, 2, 64


@pytest.fixture(autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _seg_additive_mask(q_seg, kv_seg):
    """``[B, 1, Sq, Sk]`` additive: 0 where the segment ids are equal,
    -inf elsewhere (the JAX package's form, which lets equal negative ids
    match; the kernels never do, and no caller pairs them)."""
    eq = q_seg[:, None, :, None] == kv_seg[:, None, None, :]
    return torch.zeros(eq.shape, dtype=torch.float32).masked_fill(
        ~eq, float("-inf"))


def _ref_ext(q, k, v, mask, q_seg, kv_seg, causal, scale):
    """The JAX package's ``_ref_ext``: ``_attention_ref`` with the segment
    ids folded into the mask as :func:`_seg_additive_mask` (a bool mask
    turned additive first)."""
    if q_seg is not None:
        seg_m = _seg_additive_mask(q_seg, kv_seg)
        if mask is not None and mask.dtype == torch.bool:
            mask = torch.zeros(mask.shape, dtype=torch.float32).masked_fill(
                ~mask, float("-inf"))
        mask = seg_m if mask is None else mask + seg_m
    return TFA._attention_ref(q, k, v, mask=mask, causal=causal,
                              scale=scale)


def _inputs(seed, b=1, sq=S, sk=S, h=H, hkv=HKV, d=D):
    rng = np.random.default_rng(seed)

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    return r(b, sq, h, d), r(b, sk, hkv, d), r(b, sk, hkv, d), \
        r(b, sq, h, d)


def _close(got, want, atol, name):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert np.array_equal(np.isneginf(got), np.isneginf(want)), name
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=atol, rtol=0,
                               err_msg=name)


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("seed", [0, 1, 123456789, 2 ** 31 - 2])
def test_keep_scale_equals_the_jax_hash_bit_for_bit(seed):
    for bh in (0, 7, 1000):
        for p in (0.1, 0.5, 0.9):
            for q0, k0 in ((0, 0), (128, 384), (1920, 64)):
                want = np.asarray(JK._keep_scale(jnp.int32(seed), bh, q0,
                                                 k0, 64, 128, p))
                got = TK.keep_scale(seed, bh, q0, k0, 64, 128, p).numpy()
                assert got.dtype == want.dtype
                assert np.array_equal(got, want), (seed, bh, p, q0, k0)


def test_keep_bhqk_is_keep_scale_of_each_query_head():
    ks = TK.keep_bhqk(5, 2, 3, 16, 24, 0.3)
    for b in range(2):
        for h in range(3):
            assert torch.equal(ks[b, h],
                               TK.keep_scale(5, b * 3 + h, 0, 0, 16, 24, 0.3))


def _segments(kind, b=1, sq=S, sk=S):
    """(q_seg, kv_seg) int32 of one parity case."""
    if kind == "packed, dead row":
        # packed documents; row 9 belongs to no document (-1): it sees
        # no key
        qs = (np.arange(sq) // 100).astype(np.int32)[None].repeat(b, 0)
        ks = (np.arange(sk) // 100).astype(np.int32)[None].repeat(b, 0)
        qs[:, 9] = -1
        return qs, ks
    if kind == "key padding":
        # right-padded rows, the JAX package's bool-mask encoding
        lens = [sk - 37, sk // 2 + 5][:b]
        ks = np.stack([np.where(np.arange(sk) < n, 0, -2)
                       for n in lens]).astype(np.int32)
        return np.zeros((b, sq), np.int32), ks
    return None, None


KERNEL_CASES = [  # (name, causal, segments, dropout_p, batch)
    ("segments + dropout, GQA, dead row", True, "packed, dead row", 0.25, 1),
    ("key padding + dropout", True, "key padding", 0.1, 2),
    ("key padding, no dropout", True, "key padding", 0.0, 2),
    ("dropout, non-causal", False, None, 0.5, 1),
]


@pytest.mark.parametrize("case", KERNEL_CASES, ids=[c[0] for c in
                                                    KERNEL_CASES])
def test_plain_kernels_match_the_pallas_kernels(case):
    _, causal, seg_kind, p, b = case
    q, k, v, do = _inputs(21, b=b)
    qs, ks = _segments(seg_kind, b)
    seed = 99
    jseg = {} if qs is None else dict(q_seg=jnp.asarray(qs),
                                      kv_seg=jnp.asarray(ks))
    jdrop = dict(dropout_p=p, dropout_seed=jnp.asarray([seed], jnp.int32)) \
        if p else {}
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    jo, jlse = JK.fa_forward(jq, jk, jv, causal=causal, return_lse=True,
                             interpret=True, **jseg, **jdrop)
    want = JK.fa_backward(jq, jk, jv, jo, jlse, jdo, causal=causal,
                          interpret=True, **jseg, **jdrop)
    kw = dict(causal=causal, q_seg=_t(qs), kv_seg=_t(ks),
              dropout_p=p, seed=seed if p else None)
    tq, tk_, tv, tdo = map(_t, (q, k, v, do))
    out, lse = TK.fa_forward(tq, tk_, tv, return_lse=True, **kw)
    _close(out, jo, ATOL, "out")
    _close(lse, np.asarray(jlse)[:, :, 0].reshape(b, H, S), ATOL, "lse")
    grads = TK.fa_backward(tq, tk_, tv, out, lse, tdo, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), grads, want):
        _close(g, w, GRAD_ATOL, name)
    if p:
        # the JAX package's parity oracle for the dropout arm
        jref = JFA._attention_ref_hash_dropout(
            jq, jk, jv, jnp.asarray([seed], jnp.int32), p, causal=causal,
            **jseg)
        _close(out, jref, ATOL, "out vs _attention_ref_hash_dropout")
        _close(TFA._attention_ref_hash_dropout(
            tq, tk_, tv, seed, p, causal=causal, q_seg=_t(qs),
            kv_seg=_t(ks)), jref, ATOL, "the port's oracle")
    if seg_kind == "packed, dead row":
        assert np.isneginf(lse[0, :, 9]).all()
        assert (out[0, 9] == 0).all() and (grads[0][0, 9] == 0).all()


def test_dropout_needs_its_seed_and_the_resident_envelope():
    q = torch.randn(1, 8, 2, 16)
    with pytest.raises(ValueError, match="seed"):
        TK.fa_forward(q, q, q, dropout_p=0.1)
    with pytest.raises(ValueError, match="p < 1"):
        TK.fa_forward(q, q, q, dropout_p=1.0, seed=1)
    with pytest.raises(NotImplementedError, match="resident"):
        TK.fa_forward(q, q, q, dropout_p=0.1, seed=1,
                      mask=torch.zeros(1, 1, 8, 8))
    with pytest.raises(NotImplementedError, match="resident"):
        TK.fa_backward(q, torch.randn(1, 12, 2, 16), torch.randn(1, 12, 2, 16),
                       q, torch.zeros(1, 2, 8), q, dropout_p=0.1, seed=1)
    with pytest.raises(ValueError, match="pairs"):
        TK._seg_args(torch.zeros(1, 8), None, 1, 8, 8, q.device)


def _jax_vjp(f, xs, ct):
    """``f(*xs)`` and the cotangents of xs for ``ct``, by ``jax.vjp``."""
    def run(a, b_, c, ct_):
        out, vjp = jax.vjp(f, a, b_, c)
        return out, vjp(ct_)
    return jax.jit(run)(*map(jnp.asarray, xs), ct)


def test_flash_attention_bshd_key_padding_matches_jax_with_grads():
    q, k, v, do = _inputs(31, b=2, sq=64, sk=64, d=16)
    pad = np.ones((2, 1, 1, 64), bool)
    pad[0, ..., 50:] = False
    pad[1, ..., 21:] = False

    def f(a, b_, c):
        return JFA.flash_attention_bshd(Tensor(a), Tensor(b_), Tensor(c),
                                        mask=Tensor(jnp.asarray(pad)),
                                        causal=True)._data
    jout, want = _jax_vjp(f, (q, k, v), jnp.asarray(do))
    xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    TK.reset_stats()
    out = TFA.flash_attention_bshd(*xs, mask=_t(pad), causal=True)
    out.backward(_t(do))
    # the mask became segment ids: no dense [Sq, Sk] mask was built
    assert TK.stats["plain_fwd_calls"] == 1
    _close(out.detach(), jout, ATOL, "out")
    # the reference's segment oracle, keys 0 where kept and -2 elsewhere
    seg = np.where(pad[:, 0, 0], 0, -2).astype(np.int32)
    _close(_ref_ext(*map(_t, (q, k, v)), None, _t(np.zeros_like(seg)),
                    _t(seg), True, None), jout, ATOL, "_ref_ext")
    for name, x, w in zip(("dq", "dk", "dv"), xs, want):
        _close(x.grad, w, GRAD_ATOL, name)


def test_flash_attention_bshd_dropout_matches_the_jax_kernel_path(
        monkeypatch):
    """The JAX package's in-kernel dropout (its switch on, the Pallas
    kernels in interpret mode) at the seed it drew, which the test reads
    off its ``_flash_core_drop`` call and hands to the port; with a
    key-padding mask, so the segment and dropout arms run together."""
    monkeypatch.setattr(JFA, "_FORCE_INTERPRET", True)
    monkeypatch.setattr(JFA, "_kernel_dropout_enabled", lambda: True)
    seeds = []
    real = JFA._flash_core_drop

    def spy(q_, k_, v_, seed, *rest):
        seeds.append(seed)
        return real(q_, k_, v_, seed, *rest)
    monkeypatch.setattr(JFA, "_flash_core_drop", spy)
    q, k, v, do = _inputs(41, b=2, sq=128, sk=128, h=4, hkv=2)
    pad = np.ones((2, 1, 1, 128), bool)
    pad[1, ..., 77:] = False
    xs_j = [Tensor(jnp.asarray(x), stop_gradient=False) for x in (q, k, v)]
    jout = JFA.flash_attention_bshd(*xs_j, mask=Tensor(jnp.asarray(pad)),
                                    causal=True, dropout_p=0.2)
    (jout * Tensor(jnp.asarray(do))).sum().backward()
    seed = int(np.asarray(seeds[0]).reshape(-1)[0])
    xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = TFA.flash_attention_bshd(*xs, mask=_t(pad), causal=True,
                                   dropout_p=0.2, seed=seed)
    out.backward(_t(do))
    _close(out.detach(), jout._data, ATOL, "out")
    for name, x, xj in zip(("dq", "dk", "dv"), xs, xs_j):
        _close(x.grad, xj.grad._data, GRAD_ATOL, name)


UNPADDED_CASES = [  # (name, q lengths, k lengths, causal)
    ("self-attention causal", (60, 100, 40), None, True),
    ("cross-length", (50, 80), (170, 150), False),
]


@pytest.mark.parametrize("case", UNPADDED_CASES,
                         ids=[c[0] for c in UNPADDED_CASES])
def test_flash_attn_unpadded_matches_jax_with_grads(case, monkeypatch):
    """Both packages pad the packed totals to 128 with never-matching
    segment ids and take the segment arms (the JAX kernels in interpret
    mode): self-attention rides K1's arm, cross-length K6's."""
    monkeypatch.setattr(JFA, "_FORCE_INTERPRET", True)
    _, q_lens, k_lens, causal = case
    cq = np.cumsum([0, *q_lens]).astype(np.int32)
    ck = cq if k_lens is None else np.cumsum([0, *k_lens]).astype(np.int32)
    rng = np.random.default_rng(51)
    tq, tk = int(cq[-1]), int(ck[-1])
    q = rng.standard_normal((tq, 2, 64)).astype(np.float32)
    k = rng.standard_normal((tk, 2, 64)).astype(np.float32)
    v = rng.standard_normal((tk, 2, 64)).astype(np.float32)
    do = rng.standard_normal((tq, 2, 64)).astype(np.float32)
    jcq = Tensor(jnp.asarray(cq))
    jck = jcq if k_lens is None else Tensor(jnp.asarray(ck))

    def f(a, b_, c):
        return JNF.flash_attn_unpadded(Tensor(a), Tensor(b_), Tensor(c),
                                       jcq, jck, 0, 0,
                                       causal=causal)[0]._data
    jout, want = _jax_vjp(f, (q, k, v), jnp.asarray(do))
    xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    tcq = _t(cq)
    tck = tcq if k_lens is None else _t(ck)
    TK.reset_stats()
    out, none = TF.flash_attn_unpadded(*xs, tcq, tck, 0, 0, causal=causal)
    assert none is None and out.shape == (tq, 2, 64)
    out.backward(_t(do))
    _close(out.detach(), jout, ATOL, "out")
    for name, x, w in zip(("dq", "dk", "dv"), xs, want):
        _close(x.grad, w, GRAD_ATOL, name)


def test_flash_attn_unpadded_refusals():
    """What ``flash_attn_unpadded`` once refused now runs: causal packing
    with ``cu_seqlens_q`` not ``cu_seqlens_k`` (K6's bands, equal to the
    identical packing's result when the boundaries are equal), the
    returned probabilities and dropout across different padded totals
    (the dense route, the counter hash over the padded rows)."""
    q = torch.randn(20, 2, 16)
    cu = torch.tensor([0, 8, 20], dtype=torch.int32)
    dense0 = TFA.stats["dense"]
    _close(TF.flash_attn_unpadded(q, q, q, cu, cu.clone(), 12, 12,
                                  causal=True)[0],
           TF.flash_attn_unpadded(q, q, q, cu, cu, 12, 12, causal=True)[0],
           ATOL, "cross-packed causal")
    assert TFA.stats["dense"] == dense0
    out, probs = TF.flash_attn_unpadded(q, q, q, cu, cu, 12, 12,
                                        return_softmax=True)
    assert probs.shape == (2, 20, 20) and TFA.stats["dense"] == dense0 + 1
    _close(out, TF.flash_attn_unpadded(q, q, q, cu, cu, 12, 12)[0], ATOL,
           "out beside the probabilities")
    k = torch.randn(140, 2, 16)
    ck = torch.tensor([0, 70, 140])
    got, _ = TF.flash_attn_unpadded(q, k, k, cu, ck, 12, 70, dropout=0.1,
                                    seed=1)
    qs = torch.tensor([0] * 8 + [1] * 12 + [-1] * 108)[None]
    ks = torch.tensor([0] * 70 + [1] * 70 + [-2] * 116)[None]
    want = TFA.dense_attention(
        torch.nn.functional.pad(q, (0, 0, 0, 0, 0, 108))[None],
        torch.nn.functional.pad(k, (0, 0, 0, 0, 0, 116))[None],
        torch.nn.functional.pad(k, (0, 0, 0, 0, 0, 116))[None],
        q_seg=qs, kv_seg=ks, dropout_p=0.1, seed=1)
    _close(got, want[0, :20], 0.0, "dropout across padded totals")
    # equal padded totals: dropout runs the counter hash per document
    out, _ = TF.flash_attn_unpadded(q, q, q, cu, cu, 12, 12, dropout=0.3,
                                    seed=5, causal=True)
    seg = torch.tensor([0] * 8 + [1] * 12 + [-1] * 108)[None]
    qp = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, 108))[None]
    want = TFA._attention_ref_hash_dropout(qp, qp, qp, 5, 0.3, causal=True,
                                           q_seg=seg,
                                           kv_seg=torch.where(seg < 0, -2,
                                                              seg))
    _close(out, want[0, :20], ATOL, "unpadded dropout")


def test_flash_attention_takes_its_dropout_seed():
    """``flash_attention`` (``paddle.nn.functional.flash_attention``)
    drops links at the caller's seed, and raises without one (no draw from
    a global default); without training it takes no dropout; what it
    cannot take raises."""
    q = torch.randn(1, 16, 2, 16, generator=torch.Generator().manual_seed(1))
    out, none = TFA.flash_attention(q, q, q, dropout=0.3, causal=True,
                                    seed=2 ** 31 - 2)
    assert none is None
    _close(out, TFA._attention_ref_hash_dropout(q, q, q, 2 ** 31 - 2, 0.3,
                                                causal=True), ATOL, "out")
    with pytest.raises(ValueError, match="seed="):
        TFA.flash_attention(q, q, q, dropout=0.3, causal=True)
    _close(TFA.flash_attention(q, q, q, dropout=0.3, causal=True,
                               training=False)[0],
           TFA._attention_ref(q, q, q, causal=True), ATOL, "eval")
    out, probs = TFA.flash_attention(q, q, q, return_softmax=True)
    _close(out, TFA._attention_ref(q, q, q), ATOL, "return_softmax out")
    _close(probs.sum(-1), torch.ones(1, 2, 16), ATOL, "probabilities")
    with pytest.raises(NotImplementedError, match="fixed_seed_offset"):
        TFA.flash_attention(q, q, q, fixed_seed_offset=torch.zeros(2))


def test_dropout_modes_and_axis():
    """``nn.functional.dropout``'s modes and ``axis``, as the JAX
    package's: one keep bit per index of ``axis``, kept values scaled by
    1 / (1 - p) in ``upscale_in_train``, left as they are in
    ``downscale_in_infer`` (which scales by 1 - p outside training)."""
    x = torch.ones(64, 8, 4)
    g = torch.Generator().manual_seed(3)
    y = TF.dropout(x, 0.25, axis=1, generator=g)
    assert set(y.unique().tolist()) == {0.0, float(torch.tensor(4 / 3))}
    assert (y == y[:1, :, :1]).all()          # constant off the axis
    z = TF.dropout(x, 0.25, mode="downscale_in_infer", generator=g)
    assert set(z.unique().tolist()) == {0.0, 1.0}
    assert torch.equal(TF.dropout(x, 0.25, training=False,
                                  mode="downscale_in_infer"), x * 0.75)
    assert TF.dropout(x, 0.25, training=False) is x
