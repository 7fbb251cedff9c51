"""The attention cases that no kernel arm of paddle_tpu_torch takes, held
against paddle_tpu on the CPU on the same numpy inputs.

- B1, returned probabilities: ``flash_attention_bshd(return_probs=True)``,
  ``flash_attention(return_softmax=True)`` and ``flash_attn_unpadded(
  return_softmax=True)`` (``[H, tq, tk]``) against the JAX package's XLA
  reference at p = 0, probabilities and ``out`` to 1e-5 in float32.
- B2, dropout beside a dense mask, beside FlashMask bands and across
  different padded totals: the dense route draws with the kernels'
  counter hash at ``seed=`` (torch cannot reproduce the JAX package's
  threefry mask), so it is held in distribution (the kept share of the
  live links within 3 sigma of 1 - p, each kept link scaled by 1 / (1 -
  p), ``out`` the returned probabilities times V) and, under a mask that
  keeps every link, bit for bit against K1's plain dropout arm.
- B3, causal ``flash_attn_unpadded`` whose ``cu_seqlens_q`` is not
  ``cu_seqlens_k``: K6's two FlashMask bands (their plain version here),
  forward and gradients against the JAX package's per-document XLA form
  to 1e-5, and its returned probabilities (the dense route).

The JAX package's references run as one program each (its
``jit.to_static``): the same values as op by op, with one compile.
- B4, the whole ``fused_rotary_position_embedding`` of
  ``incubate.nn.functional``: each style, with and without tables
  (half- and full-width) and position ids, to 1e-6.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as P
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.incubate.nn.functional import \
    fused_rotary_position_embedding as jax_rope
from paddle_tpu.nn.functional import flash_attention as JNF
from paddle_tpu.ops.pallas import flash_attention as JFA
from paddle_tpu_torch.incubate.nn.functional import \
    fused_rotary_position_embedding as rope
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops import fa_kernel as TK
from paddle_tpu_torch.ops import flash_attention as TFA

ATOL = 1e-5
B, S, H, D = 2, 64, 4, 16
P_DROP = 0.25


@pytest.fixture(autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _j(x):
    return Tensor(jnp.asarray(x))


def _static(fn, *args):
    """``fn`` on the JAX package's Tensors as one program (its
    ``jit.to_static``): the same values as op by op, with one compile."""
    return P.jit.to_static(fn)(*args)


def _np(x):
    return np.asarray(x._data if isinstance(x, Tensor) else
                      x.detach().numpy(), np.float32)


# -- B1: returned probabilities -------------------------------------------

@pytest.mark.parametrize("kind", ["causal", "mask", "cross-length"])
def test_returned_probabilities_match_jax(kind):
    sk = S + 32 if kind == "cross-length" else S
    q, k, v = _arrays(1, (B, S, H, D), (B, sk, H, D), (B, sk, H, D))
    mask = None
    if kind == "mask":
        mask = np.random.default_rng(2).random((B, 1, S, sk)) > 0.3
        mask[..., 0] = True
    jout, jprobs = _static(lambda *x: JFA.flash_attention_bshd(
        *x, mask=None if mask is None else _j(mask),
        causal=kind != "mask", return_probs=True), _j(q), _j(k), _j(v))
    dense0 = TFA.stats["dense"]
    out, probs = TFA.flash_attention_bshd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        mask=None if mask is None else torch.from_numpy(mask),
        causal=kind != "mask", return_probs=True)
    assert TFA.stats["dense"] == dense0 + 1
    assert probs.shape == (B, H, S, sk)
    np.testing.assert_allclose(_np(probs), _np(jprobs), atol=ATOL, rtol=0)
    np.testing.assert_allclose(_np(out), _np(jout), atol=ATOL, rtol=0)


def test_flash_attention_and_unpadded_return_softmax_match_jax():
    q, = _arrays(3, (1, S, H, D))
    jout, jprobs = _static(lambda x: JNF.flash_attention(
        x, x, x, causal=True, return_softmax=True), _j(q))
    out, probs = TFA.flash_attention(*(torch.from_numpy(q),) * 3,
                                     causal=True, return_softmax=True)
    np.testing.assert_allclose(_np(probs), _np(jprobs), atol=ATOL, rtol=0)
    np.testing.assert_allclose(_np(out), _np(jout), atol=ATOL, rtol=0)
    cu = np.array([0, 20, 50, 64], np.int32)
    qu = q[0]
    jcu = _j(cu)
    jout, jprobs = _static(lambda x: JNF.flash_attn_unpadded(
        x, x, x, jcu, jcu, 30, 30, causal=True, return_softmax=True),
        _j(qu))
    cut = torch.from_numpy(cu)
    out, probs = TF.flash_attn_unpadded(*(torch.from_numpy(qu),) * 3, cut,
                                        cut, 30, 30, causal=True,
                                        return_softmax=True)
    assert probs.shape == (H, 64, 64)
    np.testing.assert_allclose(_np(probs), _np(jprobs), atol=ATOL, rtol=0)
    np.testing.assert_allclose(_np(out), _np(jout), atol=ATOL, rtol=0)


# -- B2: dropout outside the kernels' arms --------------------------------

def _held_in_distribution(probs, undropped, v, out, name):
    """The kept share of the live links within 3 sigma of 1 - p, each
    kept link its undropped probability over 1 - p, and ``out`` the
    returned probabilities times (head-repeated) V."""
    live = undropped > 0
    kept = (probs > 0) & live
    n = int(live.sum())
    share = int(kept.sum()) / n
    sigma = (P_DROP * (1 - P_DROP) / n) ** 0.5
    assert abs(share - (1 - P_DROP)) <= 3 * sigma, (name, share, n)
    torch.testing.assert_close(probs[kept], undropped[kept] / (1 - P_DROP),
                               rtol=1e-6, atol=0)
    g = probs.shape[1] // v.shape[2]
    torch.testing.assert_close(
        out, torch.einsum("bhqk,bkhd->bqhd", probs,
                          v.repeat_interleave(g, dim=2)),
        rtol=0, atol=ATOL)


@pytest.mark.parametrize("kind", ["dense mask", "cross-length",
                                  "flashmask"])
def test_dropout_outside_the_kernel_arms_in_distribution(kind):
    sk = S + 64 if kind == "cross-length" else S
    q, k, v = (torch.from_numpy(x) for x in _arrays(
        4, (B, S, H, D), (B, sk, 2, D), (B, sk, 2, D)))
    keep = None
    if kind == "dense mask":
        keep = torch.rand(B, 1, S, sk, generator=torch.Generator()
                          .manual_seed(5)) > 0.3
    fm = ()
    if kind == "flashmask":
        # the window of 16 as one band: column j masks rows >= j + 17
        fm = (torch.arange(S, dtype=torch.int32)[None, None] + 17,
              torch.full((1, 1, S), 2 ** 31 - 1, dtype=torch.int32))
    mask = None if keep is None else torch.where(keep, 0.0, float("-inf"))
    kw = dict(causal=kind != "dense mask", mask=mask, fm=fm)
    _, undropped = TFA.dense_attention(q, k, v, return_probs=True, **kw)
    out, probs = TFA.dense_attention(q, k, v, dropout_p=P_DROP, seed=11,
                                     return_probs=True, **kw)
    _held_in_distribution(probs, undropped, v, out, kind)
    # the public entries take this route at the same seed
    if kind == "flashmask":
        got = TF.flashmask_attention(q, k, v, window_size=16,
                                     dropout=P_DROP, seed=11)
    else:
        got = TFA.flash_attention_bshd(q, k, v, mask=keep,
                                       causal=kind != "dense mask",
                                       dropout_p=P_DROP, seed=11)
    torch.testing.assert_close(got, out, rtol=0, atol=0)


def test_unpadded_dropout_across_padded_totals_in_distribution():
    q, k = (torch.from_numpy(x) for x in _arrays(6, (40, H, D), (200, H, D)))
    cq = torch.tensor([0, 15, 40], dtype=torch.int32)
    ck = torch.tensor([0, 120, 200], dtype=torch.int32)
    _, undropped = TF.flash_attn_unpadded(q, k, k, cq, ck, 25, 120,
                                          return_softmax=True)
    out, probs = TF.flash_attn_unpadded(q, k, k, cq, ck, 25, 120,
                                        dropout=P_DROP, seed=12,
                                        return_softmax=True)
    assert probs.shape == (H, 40, 200)
    _held_in_distribution(probs[None], undropped[None], k[None], out[None],
                          "unpadded")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_under_an_all_keep_mask_is_the_k1_arm_bit_for_bit(dtype):
    """A dense mask that keeps every link sends dropout to the dense
    route; it must draw K1's counter-hash pattern and round as K1's plain
    dropout arm, forward and backward."""
    q, k, v, do = (torch.from_numpy(x).to(dtype) for x in _arrays(
        7, (B, S, H, D), (B, S, 2, D), (B, S, 2, D), (B, S, H, D)))
    dense0 = TFA.stats["dense"]
    res = []
    for mask in (torch.ones(S, S, dtype=torch.bool), None):
        x = [t.clone().requires_grad_() for t in (q, k, v)]
        out = TFA.flash_attention_bshd(*x, mask=mask, causal=True,
                                       dropout_p=P_DROP, seed=2 ** 31 - 2)
        out.backward(do)
        res.append((out.detach(), *(t.grad for t in x)))
    assert TFA.stats["dense"] == dense0 + 1
    want = TK.fa_forward_plain(q, k, v, causal=True, dropout_p=P_DROP,
                               seed=2 ** 31 - 2)
    assert torch.equal(res[1][0], want)
    assert torch.equal(res[0][0], want)
    for got, ref in zip(res[0][1:], res[1][1:]):
        torch.testing.assert_close(got, ref, rtol=0,
                                   atol=ATOL if dtype == torch.float32
                                   else 2e-2)


# -- B3: causal packing with different q and k boundaries ---------------

def test_cross_packed_causal_unpadded_matches_jax_forward_and_grads():
    cq = np.array([0, 5, 12, 20, 31], np.int32)
    ck = np.array([0, 7, 9, 30, 35], np.int32)
    q, k, v, do = _arrays(8, (31, H, D), (35, H, D), (35, H, D),
                          (31, H, D))
    jx = [_j(a) for a in (q, k, v)]
    for t in jx:
        t.stop_gradient = False
    jout = _static(lambda *x: JNF.flash_attn_unpadded(
        *x, _j(cq), _j(ck), 11, 21, causal=True)[0], *jx)
    (jout * _j(do)).sum().backward()
    tx = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    TK.reset_stats()
    dense0 = TFA.stats["dense"]
    out, none = TF.flash_attn_unpadded(*tx, torch.from_numpy(cq),
                                       torch.from_numpy(ck), 11, 21,
                                       causal=True)
    out.backward(torch.from_numpy(do))
    assert none is None and TFA.stats["dense"] == dense0
    assert TK.stats["plain_fwd_calls"] == TK.stats["plain_bwd_calls"] == 1
    np.testing.assert_allclose(_np(out), _np(jout), atol=ATOL, rtol=0)
    for name, t, j in zip(("dq", "dk", "dv"), tx, jx):
        np.testing.assert_allclose(t.grad.numpy(), _np(j.grad), atol=ATOL,
                                   rtol=0, err_msg=name)
    # its probabilities [H, tq, tk] come from the dense route
    _, jprobs = _static(lambda *x: JNF.flash_attn_unpadded(
        *x, _j(cq), _j(ck), 11, 21, causal=True, return_softmax=True),
        *jx)
    _, probs = TF.flash_attn_unpadded(*tx, torch.from_numpy(cq),
                                      torch.from_numpy(ck), 11, 21,
                                      causal=True, return_softmax=True)
    assert TFA.stats["dense"] == dense0 + 1
    np.testing.assert_allclose(_np(probs), _np(jprobs), atol=ATOL, rtol=0)


def test_cross_packed_causal_bands_are_the_per_document_mask():
    """K6's two bands over the padded totals equal the per-document
    causal mask of the JAX package's XLA form; padding columns mask every
    row and padding rows see no key."""
    cq = torch.tensor([0, 5, 12, 20])
    ck = torch.tensor([0, 7, 9, 30])
    bands = TF._cross_causal_bands(cq, ck, 30, 128, 128)
    rows = torch.arange(128)[:, None]
    dead = torch.zeros(128, 128, dtype=torch.bool)
    for start, end in zip(bands[0::2], bands[1::2]):
        dead |= (rows >= start[0, 0]) & (rows < end[0, 0])
    sq = TF._segments_of(20, cq, 0, 0)[0]
    sk = TF._segments_of(30, ck, 0, 0)[0]
    pq = torch.arange(20) - cq[sq]
    pk = torch.arange(30) - ck[sk]
    want = torch.zeros(128, 128, dtype=torch.bool)
    want[:20, :30] = (sq[:, None] == sk[None]) & (pq[:, None] >= pk[None])
    assert torch.equal(~dead, want)


# -- B4: fused_rotary_position_embedding, whole ---------------------------

@pytest.mark.parametrize("neox", [True, False])
@pytest.mark.parametrize("table", [None, "half", "full"])
@pytest.mark.parametrize("with_positions", [True, False])
def test_fused_rope_matches_jax(neox, table, with_positions):
    q, k, v = _arrays(9, (2, 6, 3, 8), (2, 6, 1, 8), (2, 6, 1, 8))
    rng = np.random.default_rng(10)
    pos = rng.integers(0, 10, (2, 6)).astype(np.int32)
    tabs = {}
    if table:
        n = 10 if with_positions else 6
        w = 8 if table == "full" else 4
        tabs = dict(zip(("sin", "cos"), _arrays(11, (1, 1, n, w),
                                                (1, 1, n, w))))
    want = jax_rope(_j(q), _j(k), _j(v), position_ids=(
        _j(pos) if with_positions else None), use_neox_rotary_style=neox,
        **{n_: _j(a) for n_, a in tabs.items()})
    got = rope(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
               position_ids=(torch.from_numpy(pos) if with_positions
                             else None), use_neox_rotary_style=neox,
               **{n_: torch.from_numpy(a) for n_, a in tabs.items()})
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(_np(g), _np(w), atol=1e-6, rtol=0,
                                   err_msg=name)
    assert rope(torch.from_numpy(q))[1:] == (None, None)
