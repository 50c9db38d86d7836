"""Parity of the port's multi-tenant search (`repro_torch.engine.tenant`,
`RetrievalEngine.search_tenants`, `launch/serve.TenantServer`) with the
JAX package's, on the CPU.

Mirrors tests/test_tenant.py and tests/test_tenant_property.py case by
case. The coalesced search must equal, bit for bit, both the JAX
package's `search_tenants` (its `full` pinned to backend "ref": the
Pallas string search is dead on the installed JAX, ROADMAP C.R1) and the
port's own solo search of each tenant's queries in batch order, on every
mode x backend x packed / unpacked route. Fixture: 5 tenants of ragged
capacities, one never written, one tie-heavy, masked rows inside the
top-k.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.avss import SearchConfig as JSearchConfig
from repro.core.memory import MemoryConfig as JMemoryConfig
from repro.engine import MemoryStore as JStore
from repro.engine import RetrievalEngine as JEngine
from repro.engine import SearchRequest as JRequest
from repro.engine import TenantStore as JTenants
from repro.engine import tenant_query_rank as j_rank
from repro.launch.serve import TenantServer as JServer
from repro_torch.core.avss import SearchConfig
from repro_torch.core.memory import MemoryConfig
from repro_torch.engine import (MemoryStore, RetrievalEngine, SearchRequest,
                                TenantStore, tenant_query_rank)
from repro_torch.engine import engine as engine_lib
from repro_torch.launch import serve as serve_lib
from repro_torch.launch.serve import TenantServer

torch.set_num_threads(1)

CAPS = (12, 7, 16, 5, 9)
EMPTY = 3        # tenant created and calibrated, never written
TIE_HEAVY = 2    # tenant whose rows repeat 4x
DIM = 20
K = 4
LEAVES = ("votes", "dist", "indices", "labels")
TIDS = np.array([0, 2, 1, 0, 2, 4, 2, 3, 0, 1])


def _cfgs(cl=4):
    return (JSearchConfig("mtmc", cl=cl, mode="avss", use_kernel="ref"),
            SearchConfig("mtmc", cl=cl, mode="avss", use_kernel="ref"))


@functools.cache
def _jax_tenants(search_cfg, request):
    return jax.jit(lambda ts, q, t: JEngine(search_cfg).search_tenants(
        ts, q, t, request))


def jax_tenants(jstack, q, tids, **req):
    if req.get("mode") == "full":
        req["backend"] = "ref"
    return _jax_tenants(jstack.cfgs[0].search, JRequest(**req))(
        jstack, jnp.asarray(q), jnp.asarray(tids, jnp.int32))


def _dyadic(rng, n):
    """A calibration sample whose reductions are exact in float32."""
    x = (rng.integers(-24, 25, (n, DIM)) / 4.0).astype(np.float32)
    return np.concatenate([x, -x])


def _make_stores(caps, seed, *, empty=None, tie=None, masked=True):
    """(jax stores, port stores) of the same quantized rows: the port's,
    carried to the JAX package leaf for leaf (tests/test_torch_engine.py
    holds the programming of both packages equal)."""
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(seed)
    ts = []
    for i, c in enumerate(caps):
        if i == empty:
            ts.append(MemoryStore.create(MemoryConfig(
                capacity=c, dim=DIM, search=tcfg), device="cpu").calibrate(
                    _dyadic(rng, 4)))
            continue
        v = rng.integers(0, tcfg.enc.levels, size=(c, DIM))
        if i == tie:
            v = np.concatenate([v[:4]] * 4)[:c]
        lab = rng.integers(0, 5, size=(c,))
        if masked:
            lab[::4] = -1
        ts.append(MemoryStore.from_quantized(v, lab, tcfg, device="cpu"))
    return [_to_jax(s, jcfg) for s in ts], ts


_jax_stack = jax.jit(JTenants.stack)


@pytest.fixture(scope="module")
def tenant_fixture():
    js, ts = _make_stores(CAPS, 0, empty=EMPTY, tie=TIE_HEAVY)
    q = np.random.default_rng(1).integers(0, 4, size=(10, DIM))
    return js, ts, _jax_stack(js), TenantStore.stack(ts), q


def _check(tres, jres, solo_fn, caps, tids, mode, k, ctx=""):
    """tres equals jres on every leaf, and each tenant's rows its solo
    search's; columns past a tenant's rows are masked pads. Where a
    shortlist runs past a tenant's valid rows, the stack's pad rows rank
    among its masked rows (as in the JAX package), so there the solo
    search is held on the valid candidates and the rest must be masked."""
    for f in LEAVES:
        np.testing.assert_array_equal(getattr(tres, f).numpy(),
                                      np.asarray(getattr(jres, f)),
                                      err_msg=f"{ctx}: {f} vs JAX")
    np.testing.assert_array_equal(tres.predict().numpy(),
                                  np.asarray(jres.predict()), err_msg=ctx)
    for t, cap in enumerate(caps):
        sel = np.where(tids == t)[0]
        if not len(sel):
            continue
        solo = solo_fn(t, sel)
        width = cap if mode == "full" else min(k, cap)
        for r, b in enumerate(sel):
            n = width if mode == "full" else int((solo.labels[r] >= 0).sum())
            for f in LEAVES:
                assert torch.equal(getattr(tres, f)[b, :n],
                                   getattr(solo, f)[r, :n]), (ctx, t, f)
            assert bool((tres.votes[b, n:] == -np.inf).all()), (ctx, t)


@pytest.mark.parametrize("backend", ["ref", "mxu", "fused"])
@pytest.mark.parametrize("mode", ["full", "two_phase", "ideal"])
@pytest.mark.parametrize("packed", [True, False])
def test_search_tenants_bit_parity(tenant_fixture, mode, backend, packed):
    js, ts, jstack, tstack, q = tenant_fixture
    if not packed:
        jstack = dataclasses.replace(jstack, proj_packed=None)
        tstack = dataclasses.replace(tstack, proj_packed=None)
        ts = [dataclasses.replace(s, proj_packed=None) for s in ts]
    eng = RetrievalEngine(ts[0].cfg.search)
    req = dict(mode=mode, k=K, backend=backend)
    res = eng.search_tenants(tstack, q, TIDS, SearchRequest(**req))
    _check(res, jax_tenants(jstack, q, TIDS, **req),
           lambda t, sel: eng.search(ts[t], q[sel], SearchRequest(**req)),
           CAPS, TIDS, mode, K, f"{mode}/{backend}/packed={packed}")


def test_empty_tenant_predicts_sentinel(tenant_fixture):
    _, _, _, tstack, q = tenant_fixture
    res = RetrievalEngine(tstack.cfg.search).search_tenants(
        tstack, q, TIDS, SearchRequest(mode="two_phase", k=K))
    preds = res.predict().numpy()
    assert (preds[TIDS == EMPTY] == -1).all()


def test_k_beyond_tenant_capacity_pads_masked(tenant_fixture):
    """k past the smallest tenant's capacity: the extra columns are masked
    pads (-inf, label -1), never another tenant's rows; equal to JAX."""
    _, _, jstack, tstack, q = tenant_fixture
    k = min(CAPS) + 2
    res = RetrievalEngine(tstack.cfg.search).search_tenants(
        tstack, q, TIDS, SearchRequest(mode="two_phase", k=k))
    jres = jax_tenants(jstack, q, TIDS, mode="two_phase", k=k)
    for f in LEAVES:
        np.testing.assert_array_equal(getattr(res, f).numpy(),
                                      np.asarray(getattr(jres, f)))
    for t in (int(np.argmin(CAPS)), EMPTY):
        sel = TIDS == t
        start = 0 if t == EMPTY else CAPS[t]
        assert (res.labels[sel][:, start:] == -1).all()
        assert (res.votes[sel][:, start:] == -np.inf).all()


def test_noiseless_parity(tenant_fixture):
    js, ts, jstack, tstack, q = tenant_fixture
    eng = RetrievalEngine(tstack.cfg.search)
    req = dict(mode="two_phase", k=K, noisy=False)
    _check(eng.search_tenants(tstack, q, TIDS, SearchRequest(**req)),
           jax_tenants(jstack, q, TIDS, **req),
           lambda t, sel: eng.search(ts[t], q[sel], SearchRequest(**req)),
           CAPS, TIDS, "two_phase", K, "noiseless")


def test_tenant_query_rank():
    t = np.array([0, 2, 1, 0, 2, 4, 2, 3, 0, 1])
    ranks = tenant_query_rank(torch.as_tensor(t))
    assert ranks.tolist() == [0, 0, 0, 1, 1, 0, 2, 0, 2, 1]
    assert ranks.tolist() == np.asarray(j_rank(jnp.asarray(t))).tolist()


def test_stack_round_trip(tenant_fixture):
    js, ts, jstack, tstack, _ = tenant_fixture
    assert tstack.n_tenants == len(CAPS) and tstack.n_pad == max(CAPS)
    assert tstack.capacities == CAPS
    for f in ("values", "proj_packed", "s_grid", "labels", "size", "lo",
              "hi", "sketch_sums", "sketch_counts"):
        np.testing.assert_array_equal(getattr(tstack, f).numpy(),
                                      np.asarray(getattr(jstack, f)),
                                      err_msg=f)
    for i, s in enumerate(ts):
        t = tstack.tenant(i)
        for f in ("values", "proj", "proj_packed", "s_grid", "labels",
                  "size", "lo", "hi", "sketch_sums", "sketch_counts"):
            assert torch.equal(getattr(t, f), getattr(s, f)), (i, f)
        assert t.cfg == s.cfg and t.calibrated == s.calibrated
    view = tstack.query_view(torch.as_tensor(TIDS))
    assert view.values.shape == (len(TIDS), max(CAPS), DIM)
    assert torch.equal(view.labels[1], tstack.labels[2])


def test_stack_rejects_mismatched_stores():
    _, cfg = _cfgs()
    _, other = _cfgs(cl=8)
    a = MemoryStore.from_quantized(np.zeros((2, 8), np.int32), [0, 1], cfg,
                                   device="cpu")
    b = MemoryStore.from_quantized(np.zeros((2, 8), np.int32), [0, 1],
                                   other, device="cpu")
    c = MemoryStore.from_quantized(np.zeros((2, 6), np.int32), [0, 1], cfg,
                                   device="cpu")
    with pytest.raises(ValueError, match="at least one store"):
        TenantStore.stack([])
    with pytest.raises(ValueError, match="SearchConfig/dim"):
        TenantStore.stack([a, b])
    with pytest.raises(ValueError, match="SearchConfig/dim"):
        TenantStore.stack([a, c])
    with pytest.raises(ValueError, match="partitioned"):
        TenantStore.stack([a, MemoryStore.from_quantized(
            np.zeros((4, 8), np.int32), [0, 1, 2, 3], cfg,
            device="cpu").shard(n_shards=2)])


def test_write_at_matches_solo_write(tenant_fixture):
    """write_at on the never-written tenant, twice (the second wraps its
    5-row ring), equals the solo write and the JAX package's write_at."""
    js, ts, jstack, tstack, _ = tenant_fixture
    rng = np.random.default_rng(7)
    solo, jst = ts[EMPTY], jstack
    for n in (3, 4):
        vecs = rng.normal(size=(n, DIM)).astype(np.float32)
        labs = rng.integers(0, 9, n)
        tstack = tstack.write_at(EMPTY, vecs, labs)
        solo = solo.write(vecs, labs)
        jst = jax.jit(lambda s, v, lab: s.write_at(EMPTY, v, lab))(
            jst, jnp.asarray(vecs), jnp.asarray(labs))
        got = tstack.tenant(EMPTY)
        for f in ("values", "proj", "proj_packed", "s_grid", "labels",
                  "size", "sketch_sums", "sketch_counts"):
            assert torch.equal(getattr(got, f), getattr(solo, f)), f
        for f in ("values", "proj_packed", "s_grid", "labels", "size",
                  "sketch_sums", "sketch_counts"):
            np.testing.assert_array_equal(getattr(tstack, f).numpy(),
                                          np.asarray(getattr(jst, f)),
                                          err_msg=f)
    assert tstack.values.shape == TenantStore.stack(ts).values.shape


def test_write_at_guards(tenant_fixture):
    _, ts, _, tstack, _ = tenant_fixture
    vecs = np.zeros((2, DIM), np.float32)
    with pytest.raises(ValueError, match="never-calibrated"):
        tstack.write_at(0, vecs, [1, 2])       # from_quantized tenant
    with pytest.raises(ValueError, match="never-calibrated"):
        tstack.quantize_queries(vecs, torch.tensor([0, 1]))
    calibrated = TenantStore.stack([ts[EMPTY], ts[EMPTY]])
    with pytest.raises(ValueError, match="exceeds"):
        calibrated.write_at(0, np.zeros((CAPS[EMPTY] + 1, DIM), np.float32),
                            np.zeros(CAPS[EMPTY] + 1))


@pytest.fixture
def launch_counter(monkeypatch):
    """Counts calls of the kernel wrappers the engine reaches (on the CPU
    they run their plain versions and launch nothing)."""
    from repro_torch.kernels import mcam_dist, mcam_search, shortlist
    counts = {}
    for mod, name in ((shortlist, "lut_shortlist_blocks"),
                      (shortlist, "lut_shortlist"),
                      (mcam_search, "mcam_rescore"),
                      (mcam_search, "mcam_search"),
                      (mcam_dist, "lut_dist_matmul")):
        fn = getattr(mod, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            counts[_name] = counts.get(_name, 0) + 1
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, name, counted)
    return counts


@pytest.mark.parametrize("mode,backend", [("two_phase", "fused"),
                                          ("two_phase", "mxu"),
                                          ("ideal", "fused"),
                                          ("full", "mxu")])
def test_one_launch_profile_for_any_tenant_mix(launch_counter, mode,
                                               backend):
    """For each tenant count (1, 5, 64) and each mix of tenants, a search
    calls the same kernel wrappers the same number of times: the torch
    analogue of JAX's one jit entry per tenant count."""
    _, cfg = _cfgs()
    eng = RetrievalEngine(cfg, backend=backend)
    req = SearchRequest(mode=mode, k=2)
    for T in (1, 5, 64):
        profiles = set()
        for trial in range(3):
            r = np.random.default_rng(100 * T + trial)
            tstack = TenantStore.stack([MemoryStore.from_quantized(
                r.integers(0, cfg.enc.levels, (6, 8)), r.integers(0, 3, 6),
                cfg, device="cpu") for _ in range(T)])
            launch_counter.clear()
            eng.search_tenants(tstack, r.integers(0, 4, (4, 8)),
                               r.integers(0, T, 4), req)
            profiles.add(tuple(sorted(launch_counter.items())))
        assert len(profiles) == 1, (T, profiles)
        assert sum(dict(profiles.pop()).values()) >= 1


# -- the property sweep of tests/test_tenant_property.py, seeded ------------

PROPERTY_CASES = [
    # caps, kfrac, mode, backend, masked, ties, seed
    ([1, 14, 3], 1.5, "two_phase", "fused", True, True, 7),
    ([5], 0.5, "full", "ref", False, False, 3),
    ([9, 2, 11, 4], 1.0, "ideal", "mxu", True, False, 11),
    ([3, 3, 3, 3, 3, 3], 0.3, "two_phase", "ref", False, True, 19),
    ([14, 1], 1.2, "full", "fused", True, True, 23),
    ([6, 13, 8], 0.8, "two_phase", "mxu", True, False, 29),
]


@pytest.mark.parametrize("case", PROPERTY_CASES,
                         ids=[f"case{i}" for i in range(len(PROPERTY_CASES))])
def test_stack_search_parity_sweep(case):
    caps, kfrac, mode, backend, masked, ties, seed = case
    rng = np.random.default_rng(seed)
    js, ts = _make_stores(caps, seed, tie=0 if ties else None,
                          masked=masked)
    k = max(1, round(kfrac * min(caps)))
    eng = RetrievalEngine(ts[0].cfg.search)
    req = dict(mode=mode, k=k, backend=backend)
    b = int(rng.integers(1, 7))
    tids = rng.integers(0, len(caps), size=(b,))
    q = rng.integers(0, 4, size=(b, DIM))
    res = eng.search_tenants(TenantStore.stack(ts), q, tids,
                             SearchRequest(**req))
    _check(res, jax_tenants(_jax_stack(js), q, tids, **req),
           lambda t, sel: eng.search(ts[t], q[sel], SearchRequest(**req)),
           caps, tids, mode, k, str(case))
    stack = TenantStore.stack(ts)
    for i, s in enumerate(ts):
        assert torch.equal(stack.tenant(i).values, s.values)
        assert (stack.labels[i, caps[i]:] == -1).all()


# -- the tenant server ---------------------------------------------------------


def _servers(seed=7, n_tenants=3, capacity=6):
    """(port server, JAX server) over the same calibrated stores: the
    port's programmed from dyadic rows, carried to JAX leaf for leaf."""
    _, tcfg = _cfgs()
    jcfg = _cfgs()[0]
    rng = np.random.default_rng(seed)
    ts = []
    for _ in range(n_tenants):
        emb = _dyadic(rng, capacity // 2)
        ts.append(MemoryStore.create(MemoryConfig(
            capacity=capacity, dim=DIM, search=tcfg), device="cpu")
            .calibrate(emb).write(emb, rng.integers(0, 4, capacity)))
    js = [_to_jax(s, jcfg) for s in ts]
    req = dict(mode="two_phase", k=3)
    return (TenantServer(RetrievalEngine(tcfg), TenantStore.stack(ts),
                         SearchRequest(**req)),
            JServer(JEngine(jcfg), _jax_stack(js), JRequest(**req)), rng)


def _to_jax(store, jcfg):
    leaves = store.to_numpy()
    return JStore(**{f: jnp.asarray(leaves[f]).astype(
        jnp.bfloat16 if f == "proj" else leaves[f].dtype)
        for f in ("values", "proj", "proj_packed", "s_grid", "labels",
                  "size", "lo", "hi", "sketch_sums", "sketch_counts")},
        cfg=JMemoryConfig(capacity=store.cfg.capacity, dim=store.dim,
                          search=jcfg), calibrated=store.calibrated)


def _same_tickets(out, jout):
    assert sorted(out) == sorted(jout)
    for tk in out:
        for f in LEAVES:
            np.testing.assert_array_equal(
                getattr(out[tk], f).numpy(),
                np.asarray(getattr(jout[tk], f)), err_msg=f"{tk}:{f}")


def test_tenant_server_coalesce_and_write():
    """submit -> flush hands each ticket its row of the direct coalesced
    call, equal to the JAX server's; a write through the server keeps
    the flush's launch profile (cache_entries)."""
    server, jserver, rng = _servers(3)
    q = rng.normal(size=(4, DIM)).astype(np.float32)
    tids = [1, 0, 2, 1]
    for srv, qq in ((server, torch.as_tensor(q)), (jserver, jnp.asarray(q))):
        tickets = [srv.submit(t, qq[i]) for i, t in enumerate(tids)]
    assert tickets == [0, 1, 2, 3]
    out, jout = server.flush(), jserver.flush()
    _same_tickets(out, jout)
    direct = server.engine.search_tenants(server.tstore, q, tids,
                                          server.request)
    for i in tickets:
        assert torch.equal(out[i].labels[0], direct.labels[i])
    entries = server.cache_entries()
    vecs = rng.normal(size=(2, DIM)).astype(np.float32)
    server.write(0, vecs, [5, 6])
    jserver.write(0, jnp.asarray(vecs), jnp.array([5, 6]))
    for i, t in enumerate(tids):
        server.submit(t, torch.as_tensor(q[i]))
        jserver.submit(t, jnp.asarray(q[i]))
    _same_tickets(server.flush(), jserver.flush())
    assert server.cache_entries() == entries


def test_tenant_server_flush_empty_queue():
    server, _, _ = _servers()
    before = server.cache_entries()
    assert server.flush() == {} and server.flush() == {}
    assert server.cache_entries() == before and server.flushes == 0


def test_tenant_server_interleaved_write_between_submits():
    """A write between submits to the same tenant: the flush serves every
    queued query against the store after the write."""
    server, jserver, rng = _servers(seed=8)
    q = rng.normal(size=(3, DIM)).astype(np.float32)
    vecs = rng.normal(size=(2, DIM)).astype(np.float32)
    for srv, conv in ((server, torch.as_tensor), (jserver, jnp.asarray)):
        t0 = srv.submit(1, conv(q[0]))
        srv.write(1, conv(vecs), conv(np.array([8, 9])))
        t1 = srv.submit(1, conv(q[1]))
        t2 = srv.submit(0, conv(q[2]))
    out = server.flush()
    assert sorted(out) == [t0, t1, t2]
    _same_tickets(out, jserver.flush())
    direct = server.engine.search_tenants(server.tstore, q, [1, 1, 0],
                                          server.request)
    for tk in (t0, t1, t2):
        for f in LEAVES:
            assert torch.equal(getattr(out[tk], f)[0],
                               getattr(direct, f)[tk]), f


def test_tenant_server_duplicate_tenant_ticket_ordering():
    """Many queries of one tenant in a flush: each ticket gets its own
    query's row (the noise rank follows the queue order)."""
    server, jserver, rng = _servers(seed=9)
    q = rng.normal(size=(5, DIM)).astype(np.float32)
    tids = [2, 2, 0, 2, 2]
    for srv, conv in ((server, torch.as_tensor), (jserver, jnp.asarray)):
        tickets = [srv.submit(t, conv(q[i])) for i, t in enumerate(tids)]
    assert tickets == [0, 1, 2, 3, 4]
    out = server.flush()
    _same_tickets(out, jserver.flush())
    same = [server.submit(2, torch.as_tensor(q[0])) for _ in range(3)]
    out2 = server.flush()
    assert sorted(out2) == same and len(out2) == 3


def test_serve_tenants_demo_matches_reference(capsys):
    """The demo (`python -m repro_torch.launch.serve --tenants`): its
    stores carried to the JAX package and the same numpy traffic give the
    same result rows on every flush; the demo prints one cache entry.
    Without --tenants the entry point runs the LM decode loop."""
    n_t, steps, batch = 4, 8, 5
    stores, rng = serve_lib.demo_stores(n_t, DIM, 12, seed=2, device="cpu")
    jcfg = JSearchConfig("mtmc", cl=8, mode="avss", use_kernel="ref")
    req = dict(mode="two_phase", k=4)
    server = TenantServer(RetrievalEngine(stores[0].cfg.search),
                          TenantStore.stack(stores), SearchRequest(**req))
    jserver = JServer(JEngine(jcfg), _jax_stack(
        [_to_jax(s, jcfg) for s in stores]), JRequest(**req))
    for step in range(steps):
        tids, q, write = serve_lib.demo_step(rng, step, n_t, batch, DIM)
        for i in range(batch):
            server.submit(int(tids[i]), torch.as_tensor(q[i]))
            jserver.submit(int(tids[i]), jnp.asarray(q[i]))
        out = server.flush()
        _same_tickets(out, jserver.flush())
        if write is not None:
            server.write(*write)
            jserver.write(write[0], jnp.asarray(write[1]),
                          jnp.asarray(write[2]))
    preds = serve_lib.serve_tenants(n_t, steps, batch, dim=DIM, capacity=12,
                                    k=4, seed=2, device="cpu")
    assert preds.tolist() == torch.cat(
        [out[i].predict() for i in sorted(out)]).tolist()
    assert "cache entries=1" in capsys.readouterr().out
    # without --tenants the entry point runs the LM decode loop
    serve_lib.main(["--steps", "1", "--batch", "1", "--prompt-len", "1",
                    "--device", "cpu"])
    assert "starcoder2-3b: 1 steps x 1 reqs in" in capsys.readouterr().out


def test_full_route_is_one_gathered_call(launch_counter, tenant_fixture):
    """A tenant `full` on a kernel backend is one call of the gathered
    physics (with each pair's dist), whatever the mix."""
    _, _, _, tstack, q = tenant_fixture
    RetrievalEngine(tstack.cfg.search, backend="mxu").search_tenants(
        tstack, q, TIDS, SearchRequest(mode="full"))
    assert launch_counter == {"mcam_rescore": 1}
    assert engine_lib.SHORTLIST_UNVISITED_PENALTY == 2.0 ** 23
