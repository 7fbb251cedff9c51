"""The page wire format and the host/disk KV tiers of
paddle_tpu_torch's serving engine against paddle_tpu on the CPU.

- Wire: the reference and the port serialize the same payload (float32,
  bfloat16, int8 codes with float32 scales) to EQUAL bytes, each
  deserializes the other's, and a flipped byte (through the CRC) or a
  truncated buffer raises ``WireFormatError``.
- Tier pools: ``HostPagePool`` over a ``DiskPagePool`` behaves the same
  in both packages over one put/get/pop/contains sequence (LRU order,
  the budget, demotion to disk and promotion back, heat ranking).
- Tier in the engine: an engine whose page pool is too small for two
  prompt families spills the first family's cached chain to the host
  pool while it serves the second and restores it for the first's next
  wave, with the streams of an engine without the cache; a corrupted
  entry is caught by the CRC and recomputed; ``clear_prefix``
  invalidates the tier.
- Pool addresses: every pool's ``data_ptr()`` is unchanged across a
  prefix import, a tier restore, a copy-on-write and ``clear_prefix``
  (the engine's CUDA graphs read the pools by address).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.serving import kvtier as jtier
from paddle_tpu.serving import pagewire as jwire
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.serving import (DiskPagePool, HostPagePool, KVTier,
                                      PagedKVCache, ServingEngine,
                                      WireFormatError, deserialize_pages,
                                      serialize_pages)
from paddle_tpu_torch.serving.kvtier import chain_key


@pytest.fixture(autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the wire format, byte for byte


def _payload(dtype, n_layers=2, n_pages=3, ps=4, kv=2, d=8, seed=0):
    """The same export-shaped payload for both packages: (meta, numpy
    k/v lists for the reference, torch k/v lists for the port)."""
    rng = np.random.default_rng(seed)
    meta = {"n_layers": n_layers, "n_kv_heads": kv, "head_dim": d,
            "page_size": ps, "dtype": dtype, "tp_degree": 1,
            "seq_len": n_pages * ps - 1, "skip_pages": 0,
            "n_pages": n_pages}
    shape, sshape = (n_pages, ps, kv, d), (n_pages, ps, kv)
    jk, jv, tk, tv = [], [], [], []
    for lst_j, lst_t in ((jk, tk), (jv, tv)):
        for _ in range(n_layers):
            x = rng.standard_normal(shape).astype(np.float32)
            if dtype == "int8":
                x = rng.integers(-127, 128, shape).astype(np.int8)
                lst_j.append(x)
                lst_t.append(torch.from_numpy(x.copy()))
            elif dtype == "bfloat16":
                lst_j.append(np.asarray(jnp.asarray(x, jnp.bfloat16)))
                lst_t.append(torch.from_numpy(x).to(torch.bfloat16))
            else:
                lst_j.append(x)
                lst_t.append(torch.from_numpy(x.copy()))
        if dtype == "int8":  # the scales after the codes, per list
            for _ in range(n_layers):
                s = rng.random(sshape).astype(np.float32)
                lst_j.append(s)
                lst_t.append(torch.from_numpy(s.copy()))
    return meta, (jk, jv), (tk, tv)


def _bits(a):
    t = torch.as_tensor(a) if isinstance(a, torch.Tensor) else None
    if t is not None:
        return t.contiguous().view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(a).tobytes()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_payloads_are_byte_equal_both_ways(dtype):
    meta, (jk, jv), (tk, tv) = _payload(dtype)
    req = {"max_new_tokens": 7, "seed": 3}
    ref = jwire.serialize_pages(meta, jk, jv, request=req)
    port = serialize_pages(meta, tk, tv, request=req)
    assert port == ref
    assert port.startswith(jwire.MAGIC)
    # each package reads the other's bytes
    m, k, v, r = deserialize_pages(ref)
    assert (m, r) == (meta, req)
    assert [x.dtype for x in k[:2]] == [tk[0].dtype] * 2
    for got, want in zip(k + v, tk + tv):
        assert got.shape == want.shape and torch.equal(got, want)
    m, k, v, r = jwire.deserialize_pages(port)
    assert (m, r) == (meta, req)
    for got, want in zip(k + v, jk + jv):
        assert _bits(got) == _bits(want)
    assert serialize_pages(m, k, v, request=req) == ref  # numpy in, too


def test_corrupt_and_truncated_payloads_raise():
    meta, _, (tk, tv) = _payload("bfloat16")
    buf = serialize_pages(meta, tk, tv)
    flipped = bytearray(buf)
    flipped[-5] ^= 0x10
    for bad in (bytes(flipped), buf[:-3], buf[:20], b"XTKV1\n" + buf[6:],
                buf + b"\0"):
        with pytest.raises(WireFormatError):
            deserialize_pages(bad)
        with pytest.raises(jwire.WireFormatError):
            jwire.deserialize_pages(bad)


# ---------------------------------------------------------------------------
# the tier pools against the reference's


def _pool_state(pool):
    st = pool.stats()
    st["ram"] = list(pool._entries)
    st["disk"] = list(pool.disk._entries)
    return st


def test_host_and_disk_pools_match_jax(tmp_path):
    pools = [cls(250, disk=dcls(str(tmp_path / name), budget_bytes=300))
             for cls, dcls, name in (
                 (HostPagePool, DiskPagePool, "t"),
                 (jtier.HostPagePool, jtier.DiskPagePool, "j"))]
    keys = [chain_key(np.arange(i + 1)) for i in range(8)]
    ops = ([("put", keys[i], bytes([i]) * 100) for i in range(4)]
           + [("get", keys[0]), ("contains", keys[1]), ("get", keys[1]),
              ("put", keys[4], b"x" * 260),          # over RAM: to disk
              ("put", keys[5], b"y" * 400),          # over both: shed
              ("get", keys[4]), ("get", keys[2]), ("pop", keys[3]),
              ("pop", keys[7]), ("hottest", 3),
              ("put", keys[6], b"z" * 120), ("get", keys[0])])
    for i, (op, *args) in enumerate(ops):
        outs = [getattr(p, op)(*args) for p in pools]
        assert outs[0] == outs[1], (i, op)
        assert _pool_state(pools[0]) == _pool_state(pools[1]), (i, op)
    st = pools[0].stats()
    assert st["demoted_pages"] > 0 and st["shed_pages"] == 1
    for p in pools:
        p.clear()
    assert _pool_state(pools[0]) == _pool_state(pools[1])
    assert pools[0].pages == 0


# ---------------------------------------------------------------------------
# the tier in the engine; pool addresses

CFG = dict(vocab_size=97, hidden_size=32, intermediate_size=64,
           num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=2, max_position_embeddings=64)


@pytest.fixture(scope="module")
def model():
    m = LlamaForCausalLM(LlamaConfig(**CFG), device="cpu", seed=0)
    m.eval()
    return m


def _family(seed, n=3):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, 97, 16).astype(np.int32)
    return [np.concatenate([shared,
                            rng.integers(0, 97, 2 + i).astype(np.int32)])
            for i in range(n)]


def _wave(eng, prompts):
    rids = [eng.add_request(p, max_new_tokens=4) for p in prompts]
    res = eng.run()
    return [res[r]["tokens"] for r in rids], [
        eng._requests[r].cached_pages for r in rids]


def test_engine_spills_and_restores_through_the_host_pool(model):
    fa, fb = _family(1), _family(2)
    cold = ServingEngine(model, page_size=4, num_pages=40, max_batch=3,
                         prefill_chunk=8, device="cpu")
    want = [_wave(cold, f)[0] for f in (fa, fb, fa)]
    pool = HostPagePool(1 << 20)
    # 11 allocatable pages: a family's wave needs 10 with its 4 cached
    # prefix pages, so family B's evicts what A left cached
    eng = ServingEngine(model, page_size=4, num_pages=12, max_batch=3,
                        prefill_chunk=8, device="cpu", prefix_cache=True,
                        host_pool=pool)
    ptrs = eng.cache.pool_ptrs()
    got = [_wave(eng, f) for f in (fa, fb)]
    m = eng.metrics
    spilled = m.tier_spill_pages.value
    assert spilled > 0 and m.prefix_evictions.value == spilled
    # A's full prompt pages the device no longer holds (by chain key)
    missing = {chain_key(p[:(d + 1) * 4]) for p in fa
               for d in range(eng.cache.probe_prefix(p, p.size + 1),
                              p.size // 4)}
    got.append(_wave(eng, fa))
    assert [g[0] for g in got] == want
    # the third wave restored A's missing pages, and every request of it
    # hit its whole chain
    assert m.tier_restore_pages.value == len(missing) > 0
    assert got[2][1] == [(p.size - 1) // 4 for p in fa]
    assert (m.tier_spill_dropped.value, m.tier_corrupt_dropped.value) == \
        (0, 0)
    assert m.host_pool_pages.value == pool.pages > 0
    assert eng.tier_stats()["restored_pages"] == \
        m.tier_restore_pages.value
    # family A's third wave spilled B's chain; B's entries corrupted at
    # rest are caught by the CRC, dropped and recomputed
    head = chain_key(fb[0][:4])
    bad = [key for key in pool._entries if key.startswith(head)]
    assert bad
    for key in bad:
        pool._entries[key] = pool._entries[key][:-1] + b"\xff"
    assert _wave(eng, fb)[0] == want[1]
    assert m.tier_corrupt_dropped.value == 1
    # clear_prefix (a weight reload) flushes the tree and the tier
    assert eng.cache.clear_prefix() > 0
    assert pool.pages == 0 and eng.cache.cached_pages == 0
    assert eng.cache.pool_ptrs() == ptrs


def test_pool_addresses_hold_across_import_restore_and_clear():
    c = PagedKVCache(2, 2, 8, page_size=4, num_pages=12, dtype="int8",
                     prefix_cache=True, device="cpu")
    ptrs = c.pool_ptrs()
    assert len(set(ptrs)) == 8
    meta, _, (tk, tv) = _payload("int8", n_pages=2)
    tok = np.arange(8, dtype=np.int32)
    meta = dict(meta, kind="prefix", cached_pages=0, prompt=tok.tolist())
    del meta["seq_len"]
    assert c.import_prefix_pages(meta, tk, tv) == 2
    assert c.pool_ptrs() == ptrs
    # the imported bytes read back through an export
    m, k, v = c.export_prefix_pages(tok)
    for got, want in zip(k + v, tk + tv):
        assert torch.equal(got, want)
    # a copy-on-write of a shared tail page, then a restore from a tier
    c.acquire_prefix("s", np.concatenate([tok, [1, 2]]), 10)
    c.append_slots("s", 2)
    c.fork("s", "t")
    _, copies = c.append_slots("t", 1)
    c.apply_copies(copies)
    assert copies and c.pool_ptrs() == ptrs
    c.free_seq("s")
    c.free_seq("t")
    pool = HostPagePool(1 << 20)
    tier = KVTier(pool)
    c.attach_tier(tier)
    c.alloc_seq("big")
    c.append_slots("big", 44)               # evicts both cached pages
    assert tier.flush() == 2 and pool.pages == 2
    c.free_seq("big")
    assert tier.restore(c, np.concatenate([tok, [5]])) == 2
    assert c.pool_ptrs() == ptrs
    _, k2, v2 = c.export_prefix_pages(tok)
    for got, want in zip(k2 + v2, tk + tv):
        assert torch.equal(got, want)
    assert c.clear_prefix() == 2 and pool.pages == 0
    assert c.pool_ptrs() == ptrs
