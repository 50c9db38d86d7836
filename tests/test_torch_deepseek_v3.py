"""DeepSeek-V3 as published (`configs/deepseek_v3_671b.
get_published_config`): the port's group-limited sigmoid router, its
held-expert layer, YaRN MLA and the in-place decode cache against the
plain reference (bench/reference/knnlm.py), on the CPU, on seeded random
weights at the published router's smoke widths (16 experts in 4 groups,
2 kept, top 4).

Tolerances, each with its reason: in float32 the port and the reference
sum the same products in another order (einsum against matmul, the
absorbed decode against the expanded prefill), so logits agree to
LOGITS_ATOL (measured under 7e-6 at these widths, whose logits are
O(1)); router choices and gates are compared exactly, both computed in
the same float32 order from the same logits.
"""

import dataclasses
import sys
from pathlib import Path

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import tree as tree_lib
from repro_torch.configs.deepseek_v3_671b import (get_config,
                                                  get_published_config,
                                                  get_published_smoke_config)
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import transformer as T

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from bench.families import knnlm  # noqa: E402
from bench.families.knnlm import _published  # noqa: E402
from bench.reference import knnlm as ref  # noqa: E402

torch.set_num_threads(2)

LOGITS_ATOL = 2e-5
BATCH, PROMPT, STEPS = 3, 5, 3


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32", param_dtype="float32")


def _model(seed=0, **kw):
    """The smoke config in float32, the port's tree given the benchmark's
    weights drawn from `seed` (`knnlm.load`), and the config.json numbers
    the reference reads."""
    cfg = _f32(get_published_smoke_config(**kw))
    c = _published(cfg) | {"rms_norm_eps": 1e-6}
    params = T.init(torch.Generator().manual_seed(seed), cfg)
    knnlm.load(params, cfg, c, seed, "cpu", torch.float32)
    return cfg, params, c


def _drawn(c, seed, layer):
    """Layer `layer`'s weights as drawn, the reference's own copy."""
    return knnlm.layer_weights(c, seed, layer, "cpu", torch.float32)


def test_published_config_keeps_the_registered_twin():
    """The registered arch stays the JAX package's (softmax router, plain
    rope); the published one carries config.json's router and YaRN."""
    reg, pub = get_config(), get_published_config(7, 8)
    assert type(reg.moe) is not type(pub.moe)
    assert (pub.n_layers, pub.moe.held, pub.moe.n_routed) == (7, 8, 256)
    assert (pub.moe.n_group, pub.moe.topk_group, pub.moe.top_k) == (8, 4, 8)
    assert pub.mla.rope_factor == 40.0 and reg.mla == dataclasses.replace(
        reg.mla)
    assert get_published_config().moe.held == 256


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_router_choices_and_gates_exact(seed):
    """The port's route_groups against the reference's router on the same
    float32 logits: the same expert sets and gates, bit for bit; the group
    limit and the bias each change choices."""
    cfg, params, c = _model(seed)
    m = cfg.moe
    g = torch.Generator().manual_seed(seed + 10)
    h = torch.randn(256, cfg.d_model, generator=g)
    p = params["groups"][1]["moe"]
    router, bias = p["router"][0], p["bias"][0]
    drawn = _drawn(c, seed, c["first_k_dense_replace"])["moe"]
    assert torch.equal(router, drawn["router"])
    assert torch.equal(bias, drawn["bias"])
    gate, eidx = moe_lib.route_groups(h @ router, bias, m)
    r = ref.route(h, router, bias, c)
    order, rorder = eidx.sort(-1), r["experts"].sort(-1)
    assert torch.equal(order.values, rorder.values)
    assert torch.equal(gate.gather(1, order.indices),
                       r["gate"].gather(1, rorder.indices))
    free = dataclasses.replace(m, topk_group=m.n_group)
    assert not torch.equal(moe_lib.route_groups(h @ router, bias, free)[1]
                           .sort(-1).values, order.values)
    unbiased = moe_lib.route_groups(h @ router, torch.zeros_like(bias), m)
    assert not torch.equal(unbiased[1].sort(-1).values, order.values)


def _decode_logits(cfg, params, tokens, inplace=False):
    """Prefill of PROMPT positions, then each later token through the
    cache -> logits (B, STEPS, V) of the decoded positions."""
    _, _, caches = T.forward(params, cfg, {"tokens": tokens[:, :PROMPT]},
                             return_cache=True)
    full = T.init_cache(cfg, BATCH, PROMPT + STEPS, "cpu")
    for c, pre in zip(full, caches):
        c["ckv"][:, :, :PROMPT] = pre["ckv"]
        c["krope"][:, :, :PROMPT] = pre["krope"]
        c["kpos"][:, :PROMPT] = pre["kpos"]
    out = []
    for pos in range(PROMPT, PROMPT + STEPS):
        logits, full = T.decode_step(params, cfg,
                                     {"tokens": tokens[:, pos:pos + 1]},
                                     full, pos, inplace=inplace)
        out.append(logits[:, 0])
    return torch.stack(out, 1)


def _reference_logits(seed, c, tokens):
    """The reference's full forward pass on the weights drawn from
    `seed`, none of them read from the port's tree."""
    top = {name: knnlm.top_weight(c, seed, name, "cpu", torch.float32)
           for name in ("embed", "final_norm", "unembed")}
    layers = [_drawn(c, seed, i) for i in range(c["num_hidden_layers"])]
    return ref.forward(layers, top["embed"], top, tokens, c)[:, PROMPT:]


@pytest.mark.parametrize("held,first", [(0, 0), (4, 8)],
                         ids=["all", "share"])
def test_prefill_then_decode_equals_reference_forward(held, first):
    """Prefill then decode through the latent cache against the
    reference's full forward pass, in float32, within LOGITS_ATOL: with
    every expert held, and with a share of 4 (the absent experts' part
    left out on both sides)."""
    cfg, params, c = _model(3, experts_held=held, first_expert=first)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT + STEPS),
                           generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        got = _decode_logits(cfg, params, tokens)
        want = _reference_logits(3, c, tokens)
    assert (got - want).abs().max() <= LOGITS_ATOL


def test_yarn_without_mscale_squared_fails(monkeypatch):
    """The softmax scale's mscale**2 is part of what the comparison holds:
    the port without it (mscale 1) leaves the reference's logits."""
    cfg, params, c = _model(5)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT + STEPS),
                           generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        want = _reference_logits(5, c, tokens)
        monkeypatch.setattr(L, "yarn_mscale", lambda factor, m: 1.0)
        got = _decode_logits(cfg, params, tokens)
    assert (got - want).abs().max() > 100 * LOGITS_ATOL


def test_yarn_frequencies_are_the_references():
    """The port's YaRN frequencies and scale against the reference's
    (both folded in float64, rounded once)."""
    cfg = get_published_config(7, 8)
    inv, cs, scale = ref.rope_table(_published(cfg), "cpu")
    sin, cos, s = L.mla_rope(cfg.mla, torch.arange(8192, 8193),
                             cfg.rope_theta)
    assert torch.equal(L.yarn_freqs(64, 10000.0, cfg.mla), inv)
    assert cs == 1.0 and s == scale
    assert abs(scale * (128 + 64) ** 0.5 - (0.1 * torch.log(
        torch.tensor(40.0)).item() + 1) ** 2) < 1e-6


def test_expert_shares_add_up_to_the_whole_layer():
    """16 routed experts split 4 ways: each share's layer output (its 4
    experts' part and the shared expert), summed with the shared expert
    counted once, equals the reference's layer with every expert."""
    cfg, _, c = _model(7)
    p = _drawn(c, 7, c["first_k_dense_replace"])["moe"]
    h = torch.randn(2, 9, cfg.d_model, generator=torch.Generator()
                    .manual_seed(8))
    total = torch.zeros_like(h)
    for s in range(4):
        share = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, experts_held=4, first_expert=4 * s))
        ps = dict(p, **{k: p[k][4 * s:4 * s + 4]
                        for k in ("we1", "we2", "we3")})
        total += moe_lib.moe_apply(ps, h, share)[0]
    sh = p["shared"]
    flat = h.reshape(-1, cfg.d_model)
    total -= 3 * ref.swiglu(flat, sh["w1"], sh["w2"], sh["w3"]).reshape(
        h.shape)
    want = ref.moe(p, flat, ref.route(flat, p["router"], p["bias"], c), c)
    assert (total.reshape(-1, cfg.d_model) - want).abs().max() <= 1e-5


def test_drawn_weights_fill_every_leaf_of_the_port():
    """`knnlm.load` gives every leaf of the port's tree a drawn tensor by
    name, and refuses a tree whose leaves are not the drawn ones: a leaf
    missing (a choice bias never made) or of another shape (a held-expert
    share of another size)."""
    cfg, params, c = _model(15, experts_held=4, first_expert=8)
    for layer, (g, i) in enumerate(knnlm._layer_slots(cfg)):
        got = dict(zip(*tree_lib.flatten_with_names(tree_lib.tree_map(
            lambda a: a[i], params["groups"][g]))))
        drawn = dict(zip(*tree_lib.flatten_with_names(_drawn(c, 15,
                                                             layer))))
        assert got.keys() == drawn.keys()
        assert all(torch.equal(got[k], drawn[k]) for k in got)
    fresh = T.init(torch.Generator().manual_seed(16), cfg)
    del fresh["groups"][1]["moe"]["bias"]
    with pytest.raises(ValueError, match="leaves"):
        knnlm.load(fresh, cfg, c, 15, "cpu", torch.float32)
    fresh = T.init(torch.Generator().manual_seed(16), cfg)
    with pytest.raises(ValueError, match="we1"):
        knnlm.load(fresh, cfg, c | {"experts_held": 2}, 15, "cpu",
                   torch.float32)


def test_held_pairs_count_the_routers_choice():
    """The family's count of a step's routed (token, held expert) pairs,
    from the router's choice the decode's taps keep: every MoE layer's
    pairs inside the held share, and the most one expert took."""
    cfg, params, c = _model(17, experts_held=4, first_expert=4)
    taps: list = []
    tokens = torch.randint(0, cfg.vocab_size, (8, 1),
                           generator=torch.Generator().manual_seed(18))
    caches = T.init_cache(cfg, 8, 4, "cpu")
    with torch.no_grad():
        T.decode_step(params, cfg, {"tokens": tokens}, caches, 0, taps=taps)
    kept = {f"{k}{i}": v for i, tap in enumerate(taps) for k, v in
            tap.items()}
    moe_layers = range(c["first_k_dense_replace"], c["num_hidden_layers"])
    mine = [((kept[f"experts{l}"] >= 4) & (kept[f"experts{l}"] < 8))
            for l in moe_layers]
    pairs, most = knnlm.held_pairs(c, kept)
    assert pairs == sum(int(x.sum()) for x in mine) > 0
    assert most == max(int(torch.bincount(kept[f"experts{l}"][x] - 4,
                                          minlength=4).max())
                       for l, x in zip(moe_layers, mine))


def test_in_place_decode_equals_functional_bit_for_bit():
    """bfloat16 at the smoke widths: decode_step(inplace=True) writes the
    same rows into the given caches and gives the same logits as the
    functional decode, which leaves its caches as they were."""
    cfg = get_published_smoke_config(4, 4)
    params = T.init(torch.Generator().manual_seed(11), cfg)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, 6),
                           generator=torch.Generator().manual_seed(12))
    a = T.init_cache(cfg, BATCH, 6, "cpu")
    b = [{k: v.clone() for k, v in c.items()} for c in a]
    for pos in range(6):
        before = [{k: v.clone() for k, v in c.items()} for c in a]
        la, a_new = T.decode_step(params, cfg, {"tokens": tokens[:, pos:
                                                              pos + 1]},
                                  a, pos)
        lb, b_new = T.decode_step(params, cfg, {"tokens": tokens[:, pos:
                                                              pos + 1]},
                                  b, pos, inplace=True)
        assert torch.equal(la, lb)
        for old, c in zip(before, a):
            assert all(torch.equal(old[k], c[k]) for k in c)
        for x, y, z in zip(a_new, b_new, b):
            assert all(y[k] is z[k] for k in y)
            assert all(torch.equal(x[k], y[k]) for k in x)
        a = a_new


class _Outputs(TorchDispatchMode):
    """The element counts of every tensor an operator makes anew (not a
    view of, or written into, one of its inputs)."""

    def __init__(self):
        super().__init__()
        self.sizes = [0]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        leaves = torch.utils._pytree.tree_leaves

        def tensors(tree):
            return [t for t in leaves(tree) if isinstance(t, torch.Tensor)]
        given = {t.untyped_storage().data_ptr()
                 for t in tensors((args, kwargs))}
        self.sizes += [t.numel() for t in tensors(out)
                       if t.untyped_storage().data_ptr() not in given]
        return out


@pytest.mark.parametrize("inplace", [True, False], ids=["serve", "kept"])
def test_in_place_decode_copies_no_cache(inplace):
    """A decode step in place makes no tensor as large as one layer's
    latent cache (its row is written where it lies); the functional step,
    which leaves its caches as they were, makes such copies."""
    cfg = get_published_smoke_config(4, 4)
    params = T.init(torch.Generator().manual_seed(13), cfg)
    caches = T.init_cache(cfg, BATCH, 64, "cpu")
    layer = caches[0]["ckv"][0].numel()
    with torch.no_grad(), _Outputs() as seen:
        T.decode_step(params, cfg, {"tokens": torch.zeros(
            (BATCH, 1), dtype=torch.int64)}, caches, 40, inplace=inplace)
    assert (max(seen.sizes) < layer) == inplace
