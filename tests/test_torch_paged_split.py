"""The two forms of paddle_tpu_torch's paged-attention kernel, as far as
they run on the CPU: the tile form's plan (runs of one lane cut into
tiles, built on the device from ``token_lane``), the split form's static
split count, and the split form's two passes in plain PyTorch
(``split_partials_plain`` then ``combine_splits_plain``) against the
plain version and against paddle_tpu's gather reference on the same
numpy inputs.

Tolerance: 1e-5 absolute in float32, the JAX package's own. The JAX
reference gives NaN for a row with no live key where the port gives 0;
such rows are held to the port's plain version alone (exactly 0). The
CUDA kernels themselves run only on the card (``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.serving import attention as JA
from paddle_tpu_torch.serving import attention as TA
from test_torch_paged_attention import MIXED, as_jax, as_torch, ragged_case

ATOL = 1e-5


@pytest.fixture(autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _plan(lanes, tokens, n_lanes):
    split_tok, tiles = TA.tile_plan(torch.tensor(lanes, dtype=torch.int32),
                                    tokens, n_lanes)
    return split_tok.tolist(), [tuple(t) for t in tiles.tolist()]


def _covered_once(split_tok, tiles, t):
    """Every token is served by exactly one form: a tile or the split."""
    seen = [0] * t
    for first, n in tiles:
        for i in range(first, first + n):
            seen[i] += 1
    for i, s in enumerate(split_tok):
        seen[i] += s
    return seen == [1] * t


def test_tile_plan_cuts_runs_of_one_lane():
    # lane 0: 5 tokens (tiles of 2, 2, 1), lane 1: one decode token, lane
    # 2: 4 tokens (2, 2), lane 3: 2 tokens (one tile)
    lanes = [0, 0, 0, 0, 0, 1, 2, 2, 2, 2, 3, 3]
    split_tok, tiles = _plan(lanes, 2, 4)
    assert split_tok == [0] * 5 + [1] + [0] * 6
    live = [t for t in tiles if t[1] > 0]
    assert live == [(0, 2), (2, 2), (4, 1), (6, 2), (8, 2), (10, 2)]
    # the bound min(T, ceil(T / tokens) + lanes) = min(12, 6 + 4)
    assert len(tiles) == 10 and tiles[6:] == [(0, 0)] * 4
    assert _covered_once(split_tok, tiles, len(lanes))


def test_tile_plan_of_the_engine_layout():
    """Lane-major tokens from ``_token_lanes``: a 64-token cut, decode
    lanes, padded lanes (no tokens) and padding tokens, which join the
    last lane's run at position 0."""
    ql = torch.tensor([1, 70, 0, 3, 1, 0], dtype=torch.int32)
    qoff = torch.tensor([9, 0, 0, 5, 40, 0], dtype=torch.int32)
    lane, pos = TA._token_lanes(ql, qoff, int(ql.sum()) + 4)
    split_tok, tiles = _plan(lane.tolist(), 64, 6)
    t = len(lane)
    assert split_tok[0] == 1                 # the first decode lane
    live = [x for x in tiles if x[1] > 0]
    # lane 1: 64 + 6 tokens; lane 3: 3; lane 5 (padded, last) has the 4
    # padding tokens, lane 4's decode token is its own run
    assert live == [(1, 64), (65, 6), (71, 3), (75, 4)]
    assert split_tok[74] == 1 and pos[75:].tolist() == [0] * 4
    assert _covered_once(split_tok, tiles, t)


def test_tile_plan_routes_tiles_past_the_bound_to_the_split_form():
    """Lanes that are not lane-major can make more tiles than the bound;
    the tokens of the extra tiles take the split form."""
    lanes = [0, 0, 1, 1, 0, 0, 1, 1, 0, 0]
    split_tok, tiles = _plan(lanes, 64, 2)   # bound min(10, 1 + 2) = 3
    assert tiles == [(0, 2), (2, 2), (4, 2)]
    assert split_tok == [0] * 6 + [1] * 4
    assert _covered_once(split_tok, tiles, len(lanes))


def test_tile_tokens_and_capability():
    assert [TA.tile_tokens(g) for g in (1, 2, 4, 8, 3, 32)] == \
        [64, 32, 16, 8, 21, 2]
    bf, f32, i8 = torch.bfloat16, torch.float32, torch.int8
    assert TA.tile_capable(bf, bf, 128) and TA.tile_capable(bf, i8, 64)
    assert not TA.tile_capable(f32, bf, 128)
    assert not TA.tile_capable(bf, f32, 128)
    assert not TA.tile_capable(bf, bf, 256)


@pytest.mark.parametrize("max_keys,window,want", [
    (4096, None, 16), (4096, 300, 2), (4096, 256, 1), (4096, 5000, 16),
    (36, None, 1), (4097, 0, 17)])
def test_static_split_count(max_keys, window, want):
    assert TA.split_count(max_keys, window) == want


def _token_args(c, int8=False, positions=None):
    k, v = as_torch(c, int8)
    lane, pos = TA._token_lanes(torch.from_numpy(c["ql"]),
                                torch.from_numpy(c["qoff"]),
                                c["q"].shape[0])
    return [torch.from_numpy(c["q"]), k, v, torch.from_numpy(c["pt"]),
            torch.from_numpy(c["cl"]), pos, lane]


def _jax_ref(c, int8, **kw):
    k, v = as_jax(c, int8)
    out = JA.ragged_paged_attention(
        jnp.asarray(c["q"]), k, v, jnp.asarray(c["pt"]),
        jnp.asarray(c["cl"]), jnp.asarray(c["ql"]), jnp.asarray(c["qoff"]),
        **kw)
    return np.asarray(out, np.float32)


# (split_keys, window, int8): spans of 5 keys over pages of 4 straddle
# pages; with window 6 the span starts inside the window's first page;
# 16 keys against contexts up to 30 leave splits empty
@pytest.mark.parametrize("split_keys,window,int8", [
    (5, None, False), (5, 6, False), (3, 7, True), (16, None, True)])
def test_split_partials_and_combine_match_the_plain_and_jax(
        split_keys, window, int8):
    c = ragged_case(MIXED, nkv=2, pad_tokens=2, pad_lanes=1, seed=20)
    args = _token_args(c, int8)
    kw = dict(scale=0.35, window=window)
    m, l, acc = TA.split_partials_plain(*args, split_keys=split_keys, **kw)
    n_keys = c["pt"].shape[1] * c["k"].shape[1]
    assert m.shape[-1] == TA.split_count(n_keys, window, split_keys)
    got = TA.combine_splits_plain(m, l, acc).numpy()
    plain = TA.ragged_paged_attention_plain(*args, **kw).numpy()
    np.testing.assert_allclose(got, plain, atol=ATOL)
    n_real = int(c["ql"].sum())
    np.testing.assert_allclose(got[:n_real], _jax_ref(c, int8, **kw)[:n_real],
                               atol=ATOL)
    # an empty split is (m, l, acc) = (-inf, 0, 0)
    empty = torch.isinf(m)
    assert empty.any() and (l[empty] == 0).all() and (acc[empty] == 0).all()


def test_rows_with_no_live_key_come_out_zero():
    """A lane whose queries sit past its context by more than the window
    has no live key: every split empty, the combine gives exactly 0."""
    c = ragged_case([(9, 1), (17, 6), (5, 2)], seed=21)
    c["qoff"][2] = 30                       # positions 30, 31; ctx 5
    args = _token_args(c)
    kw = dict(scale=0.35, window=4)
    m, l, acc = TA.split_partials_plain(*args, split_keys=3, **kw)
    got = TA.combine_splits_plain(m, l, acc).numpy()
    plain = TA.ragged_paged_attention_plain(*args, **kw).numpy()
    assert torch.isinf(m[-2:]).all() and not np.isnan(got).any()
    np.testing.assert_array_equal(got[-2:], 0.0)
    np.testing.assert_array_equal(plain[-2:], 0.0)
    np.testing.assert_allclose(got, plain, atol=ATOL)
    np.testing.assert_allclose(got[:-2], _jax_ref(c, False, **kw)[:-2],
                               atol=ATOL)


def test_a_dropped_split_changes_the_output():
    """The planted fault chip_smoke.py holds the kernels' check to: the
    combine without one live split is far from the plain version."""
    c = ragged_case(MIXED, seed=22)
    args = _token_args(c)
    m, l, acc = TA.split_partials_plain(*args, scale=0.35, split_keys=5)
    want = TA.ragged_paged_attention_plain(*args, scale=0.35)
    m[-1, :, 0] = float("-inf")             # the last token: 30 keys
    got = TA.combine_splits_plain(m, l, acc)
    assert (got[-1] - want[-1]).abs().max() > 0.05
