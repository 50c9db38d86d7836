"""The kNN-LM family: a DeepSeek-V3-style decoder served by repro_torch's
LM serving path (`launch/steps.make_serve_step_with_mcam`:
`transformer.decode_step` in place over the latent cache, then
`knn_lm_head`, whose search is `RetrievalEngine.search` over an MCAM
datastore of the model's own hidden rows), with the inputs, the check,
the control and the work counts that go with it.

A configuration (`"program": "knnlm"`) holds the model's config.json
numbers (the catalog row's keys), the layers kept (`num_hidden_layers`),
the routed experts this chip holds (`experts_held` from `first_expert`),
the datastore (`datastore`: the MCAM widths and physics of an MCAM
configuration, `capacity` keys made as `centres` x `keys_per_centre`
around the model's hidden rows at `spread` times their per-dimension
standard deviation, programmed in writes of `program_rows`) and `lam`.
A mix gives `batch` sequences a step, each at `position` (the cache
holds `position` rows from the seed and the step's own, in whole blocks
of CACHE_ROWS rows), `k` and `mode`. The program is
`get_published_config(layers, experts_held, first_expert)`; the numbers
of the file must equal its.

The inputs are drawn on the device from the seed: the weights (plain
`torch.randn` at the configuration's shapes, by the reference's names:
`layer_weights`, `top_weight`; `load` copies them into the program's
tree leaf by leaf, and the reference is handed the drawn tensors
themselves), the cache's first `position` rows of every layer
(N(0, 1) latents and rope keys, one block of sequences at a time), the
datastore (the first dims of the hidden rows of decode steps on seeded
tokens as centres, keys around them, a seeded token id each) and every
step's tokens, uniform over the vocabulary. Every step decodes at the
same position: steps do not extend one another, and each writes its row
of the cache in place.

What decides `correct` is the plain reference (bench/reference/knnlm.py,
whose search is bench/reference/mcam.py), computed after the window on
the weights and inputs drawn again from the seed (nothing of the
program's tree), for each checked
batch, and held against the program part by part, each part given the
program's own input to it (the decode's taps):

  attn_err            the attention's output from the layer's input: the
                      largest over layers of the RMS of (program -
                      reference) over the RMS of the reference
  ffn_err             the FFN's output from its normed input (the tokens
                      whose routing agrees), the same measure
  stream_err          the residual adds and the second norm, the same
                      measure of the next layer's input and of the FFN's
                      input
  router_wrong        tokens whose set of experts differs, where the
                      reference's choice is not a near-tie
  router_near_tie_pct the share of routed tokens whose reference choice
                      hangs on ROUTER_MARGIN (the k-th and (k+1)-th
                      eligible scores, or the kept and the best dropped
                      group, closer than it), in %
  query_words_wrong .. labels_wrong
                      the head's search, bit for bit, on the program's
                      own hidden rows: query words, candidate rows,
                      distances, votes, labels
  mixture_err         the largest |difference| of the mixed
                      log-probabilities, the reference's logits from the
                      program's final hidden rows
  tokens_wrong        tokens delivered home that differ from the
                      reference mixture's argmax where its two best are
                      more than TOKEN_MARGIN apart
  cache_wrong         cache entries of the seed's rows that differ after
                      the window (a step writes its own row alone)
"""

from __future__ import annotations

import dataclasses
import math
import sys
import time

import numpy as np
import torch

from bench import work as yardstick
from bench import work_lm
from bench.reference import knnlm as reference
from bench.reference import mcam
from bench.trace import SEARCH_SPAN

NUMBERS = ("attn_err", "ffn_err", "stream_err", "router_wrong",
           "router_near_tie_pct", "query_words_wrong", "rows_wrong",
           "dist_wrong", "votes_wrong", "labels_wrong", "mixture_err",
           "tokens_wrong", "cache_wrong")

#: router scores closer than this hang on the float32 products' order
#: (program and reference sum the same bfloat16 input in another order:
#: differences near 1e-7)
ROUTER_MARGIN = 1e-5
#: a delivered token is compared where the reference's two best mixed
#: log-probabilities are further apart than this
TOKEN_MARGIN = 0.1
#: sequences a block of the seeded cache rows (the draw's unit)
PREFIX_BLOCK = 64
#: the cache holds whole blocks of this many rows a sequence (a paged
#: cache's block, FlashMLA's 64), the rows past the step's own masked: at
#: 8,193 rows the latent products' odd stride sent cuBLAS to its
#: unaligned kernels, 48% of a traced window
CACHE_ROWS = 64
#: the configuration's weight precision; the router, the choice bias and
#: the norms' scales are float32
WEIGHT_DTYPE = torch.bfloat16
#: spread of the drawn norms' scales around 1 (a trained model's are not
#: all 1, and a norm that drops its scale shows)
NORM_SD = 0.1
#: spread of the drawn choice bias (`e_score_correction_bias`), which a
#: trained model learns, so that it moves choices
BIAS_SD = 0.05
#: spread of the drawn embedding rows
EMBED_SD = 0.02


def _sub(seed: int, *tags: int) -> int:
    """A seed of its own for each stream of draws."""
    out = seed % 2 ** 61
    for t in tags:
        out = (out * 1000003 + t + 1) % 2 ** 61
    return out


def _gen(device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


# -- the configuration -------------------------------------------------------


def _published(cfg) -> dict:
    """The config.json numbers of a port ModelConfig."""
    m, a = cfg.moe, cfg.mla
    return {"hidden_size": cfg.d_model, "num_attention_heads": cfg.n_heads,
            "num_key_value_heads": cfg.n_kv_heads,
            "vocab_size": cfg.vocab_size, "num_hidden_layers": cfg.n_layers,
            "intermediate_size": m.dense_d_ff,
            "moe_intermediate_size": m.d_ff,
            "first_k_dense_replace": m.first_dense_layers,
            "n_routed_experts": m.n_routed, "n_shared_experts": m.n_shared,
            "num_experts_per_tok": m.top_k, "n_group": m.n_group,
            "topk_group": m.topk_group, "norm_topk_prob": m.norm_topk_prob,
            "routed_scaling_factor": m.routed_scaling_factor,
            "q_lora_rank": a.q_lora_rank, "kv_lora_rank": a.kv_lora_rank,
            "qk_nope_head_dim": a.qk_nope_dim,
            "qk_rope_head_dim": a.qk_rope_dim, "v_head_dim": a.v_dim,
            "rope_theta": cfg.rope_theta,
            "rope_scaling": {
                "beta_fast": a.beta_fast, "beta_slow": a.beta_slow,
                "factor": a.rope_factor, "mscale": a.mscale,
                "mscale_all_dim": a.mscale_all_dim,
                "original_max_position_embeddings":
                    a.original_max_positions, "type": "yarn"},
            "experts_held": m.held, "first_expert": m.first_expert}


def model_config(config: dict):
    """The port's published config for the file; its numbers must equal
    the file's."""
    from repro_torch.configs import deepseek_v3_671b as v3
    held, first = config["experts_held"], config.get("first_expert", 0)
    if config.get("smoke"):
        cfg = v3.get_published_smoke_config(held, first,
                                            config["num_hidden_layers"])
    else:
        cfg = v3.get_published_config(config["num_hidden_layers"], held,
                                      first)
    for key, value in _published(cfg).items():
        if config[key] != value:
            raise ValueError(f"knnlm: {key} is {config[key]!r} in the "
                             f"configuration, {value!r} in the program")
    if config["hidden_act"] != "silu" or config["attention_bias"]:
        raise ValueError("knnlm: the program runs SwiGLU without biases")
    return cfg


# -- the weights -------------------------------------------------------------


class _Draws:
    """Tensors drawn in turn, each from a seed of its own."""

    def __init__(self, device, seed: int, *tags: int):
        self.device, self.seed, self.tags, self.no = device, seed, tags, 0

    def randn(self, shape: tuple) -> torch.Tensor:
        self.no += 1
        g = _gen(self.device, _sub(self.seed, *self.tags, self.no))
        return torch.randn(shape, generator=g, device=self.device)

    def matrix(self, shape: tuple, fan_in: int, dtype) -> torch.Tensor:
        return self.randn(shape).div_(math.sqrt(fan_in)).to(dtype)

    def scale(self, dim: int) -> torch.Tensor:
        return self.randn((dim,)).mul_(NORM_SD).add_(1.0)


def layer_weights(config: dict, seed: int, layer: int, device,
                  dtype=WEIGHT_DTYPE) -> dict:
    """Layer `layer`'s weights by the reference's names, drawn from the
    seed at the configuration's shapes: each matrix N(0, 1 / fan-in) in
    `dtype`, the router N(0, 1 / D) float32, the choice bias N(0,
    BIAS_SD^2) and the norms' scales 1 + N(0, NORM_SD^2) float32; the
    held experts `experts_held` of them."""
    c = config
    D, H = c["hidden_size"], c["num_attention_heads"]
    q, r, p = c["q_lora_rank"], c["kv_lora_rank"], c["qk_rope_head_dim"]
    n, v = c["qk_nope_head_dim"], c["v_head_dim"]
    d = _Draws(device, seed, 1, layer)
    out = {"norm1": {"scale": d.scale(D)},
           "attn": {"wq_a": d.matrix((D, q), D, dtype),
                    "q_norm": d.scale(q),
                    "wq_b": d.matrix((q, H, n + p), q, dtype),
                    "wkv_a": d.matrix((D, r + p), D, dtype),
                    "kv_norm": d.scale(r),
                    "wkv_b": d.matrix((r, H, n + v), r, dtype),
                    "wo_mla": d.matrix((H, v, D), H * v, dtype)},
           "norm2": {"scale": d.scale(D)}}
    if not reference.layer_is_moe(c, layer):
        f = c["intermediate_size"]
        out["mlp"] = {"w1": d.matrix((D, f), D, dtype),
                      "w2": d.matrix((f, D), f, dtype),
                      "w3": d.matrix((D, f), D, dtype)}
        return out
    f, e = c["moe_intermediate_size"], c["experts_held"]
    sf = c["n_shared_experts"] * f
    out["moe"] = {"router": d.matrix((D, c["n_routed_experts"]), D,
                                     torch.float32),
                  "bias": d.randn((c["n_routed_experts"],)).mul_(BIAS_SD),
                  "we1": d.matrix((e, D, f), D, dtype),
                  "we2": d.matrix((e, f, D), f, dtype),
                  "we3": d.matrix((e, D, f), D, dtype),
                  "shared": {"w1": d.matrix((D, sf), D, dtype),
                             "w2": d.matrix((sf, D), sf, dtype),
                             "w3": d.matrix((D, sf), D, dtype)}}
    return out


def top_weight(config: dict, seed: int, name: str, device,
               dtype=WEIGHT_DTYPE):
    """The model's `embed` (V, D) N(0, EMBED_SD^2), `final_norm`
    {scale} or `unembed` (D, V) N(0, 1 / D), drawn from the seed."""
    D, V = config["hidden_size"], config["vocab_size"]
    d = _Draws(device, seed, 2, ("embed", "final_norm", "unembed")
               .index(name))
    if name == "embed":
        return d.randn((V, D)).mul_(EMBED_SD).to(dtype)
    if name == "final_norm":
        return {"scale": d.scale(D)}
    return d.matrix((D, V), D, dtype)


def _fill(leaves: dict, drawn: dict, i: int | None, path: str) -> None:
    if set(leaves) != set(drawn):
        raise ValueError(f"knnlm: the program's leaves {sorted(leaves)} at "
                         f"{path or 'the top'} are not the drawn "
                         f"{sorted(drawn)}")
    for name, w in drawn.items():
        if isinstance(w, dict):
            _fill(leaves[name], w, i, f"{path}{name}.")
            continue
        dst = leaves[name] if i is None else leaves[name][i]
        if dst.shape != w.shape or dst.dtype != w.dtype:
            raise ValueError(f"knnlm: {path}{name} is {tuple(dst.shape)} "
                             f"{dst.dtype} in the program, {tuple(w.shape)} "
                             f"{w.dtype} drawn")
        dst.copy_(w)


def load(params: dict, cfg, config: dict, seed: int, device,
         dtype=WEIGHT_DTYPE) -> None:
    """The program's tree (`transformer.init`'s) given the drawn weights,
    leaf by leaf by name: every leaf is drawn, and every drawn tensor has
    its leaf's shape and dtype."""
    for layer, (g, i) in enumerate(_layer_slots(cfg)):
        _fill(params["groups"][g],
              layer_weights(config, seed, layer, device, dtype), i,
              f"layer {layer}: ")
    top = {k: v for k, v in params.items() if k != "groups"}
    _fill(top, {name: top_weight(config, seed, name, device, dtype)
                for name in ("embed", "final_norm", "unembed")}, None, "")


# -- the program, and its control --------------------------------------------


class Port:
    """repro_torch's weights as drawn: the configuration's bfloat16."""

    def prepare(self, params) -> None:
        pass


class Control(Port):
    """The program with every weight rounded through float8_e4m3fn, a
    lower precision than the configuration's bfloat16: the control of the
    check, which has to come out not correct."""

    def prepare(self, params) -> None:
        from repro_torch import tree as tree_lib
        for leaf in tree_lib.leaves(params):
            if leaf.is_floating_point():
                leaf.copy_(leaf.to(torch.float8_e4m3fn).to(leaf.dtype))


def control(config: dict, device) -> Control:
    return Control()


class _Recording:
    """RetrievalEngine.search, its last query and result kept for the
    check (the head calls it once a step)."""

    def __init__(self, engine):
        self.engine, self.last = engine, None

    def search(self, store, q, request):
        res = self.engine.search(store, q, request)
        self.last = (q, res)
        return res


# -- set-up ------------------------------------------------------------------


@dataclasses.dataclass
class State:
    config: dict
    traffic: dict
    cfg: object
    params: dict | None
    caches: list | None
    store: object
    step: object
    engine: _Recording
    taps: list
    tokens: torch.Generator
    centres: torch.Tensor
    seed: int
    issued: int = 0


def _seed_rows(config: dict, seed: int, layer: int, block: int, rows: int,
               position: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The cache's first `position` rows of `rows` sequences of one block
    of one layer: (latents (rows, position, r), rope keys (rows,
    position, rope)), N(0, 1), as bfloat16."""
    r, p = config["kv_lora_rank"], config["qk_rope_head_dim"]
    x = torch.randn(rows, position, r + p, device=device,
                    generator=_gen(device, _sub(seed, 3, layer, block)))
    x = x.to(torch.bfloat16)
    return x[..., :r], x[..., r:]


def _layer_slots(cfg) -> list[tuple[int, int]]:
    """(group, index in group) of each layer, in order."""
    return [(g, i) for g, (_, _, n) in enumerate(cfg.layer_groups())
            for i in range(n)]


def _fill_cache(state_cfg, config, caches, seed, position, batch, device):
    for layer, (g, i) in enumerate(_layer_slots(state_cfg)):
        c = caches[g]
        for j, b0 in enumerate(range(0, batch, PREFIX_BLOCK)):
            rows = min(PREFIX_BLOCK, batch - b0)
            ckv, krope = _seed_rows(config, seed, layer, j, rows, position,
                                    device)
            c["ckv"][i, b0:b0 + rows, :position] = ckv
            c["krope"][i, b0:b0 + rows, :position] = krope
        c["kpos"][i, :position] = torch.arange(position, device=device)


def _cache(cfg, config: dict, seed: int, batch: int, position: int,
           device) -> list:
    """The decode caches of `batch` sequences with their first `position`
    rows drawn from the seed."""
    from repro_torch.models import transformer
    rows = -(-(position + 1) // CACHE_ROWS) * CACHE_ROWS
    caches = transformer.init_cache(cfg, batch, rows, device)
    _fill_cache(cfg, config, caches, seed, position, batch, device)
    return caches


def _centres(cfg, params, caches, ds: dict, seed: int, batch: int,
             position: int, device) -> torch.Tensor:
    """The datastore's centres: the first `dim` entries of the hidden rows
    of decode steps on seeded tokens, float32."""
    from repro_torch.models import transformer
    g = _gen(device, _sub(seed, 4))
    out = []
    for _ in range(-(-ds["centres"] // batch)):
        tok = torch.randint(0, cfg.vocab_size, (batch, 1), generator=g,
                            device=device)
        _, caches, hidden = transformer.decode_step(
            params, cfg, {"tokens": tok}, caches, position,
            return_hidden=True, inplace=True)
        out.append(hidden[:, 0, :ds["dim"]].float())
    return torch.cat(out)[:ds["centres"]]


def _free(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def _keys(config: dict, centres: torch.Tensor, seed: int, device
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """The datastore: keys around the centres at `spread` times the
    centres' per-dimension standard deviation, and a token id each."""
    ds = config["datastore"]
    g = _gen(device, _sub(seed, 5))
    per = ds["keys_per_centre"]
    sd = centres.std(0, correction=0)
    x = centres.repeat_interleave(per, 0)
    x = x + ds["spread"] * sd * torch.randn(x.shape, generator=g,
                                            device=device)
    labels = torch.randint(0, config["vocab_size"], (x.shape[0],),
                           generator=g, device=device, dtype=torch.int64)
    return x, labels.to(torch.int32)


def setup(config: dict, traffic: dict, seed: int, device,
          program=None) -> State:
    """The model from the seed, the cache's seeded rows, the datastore
    programmed, the serve step built."""
    from repro_torch.core.avss import SearchConfig
    from repro_torch.core.mcam import MCAMConfig
    from repro_torch.core.memory import MemoryConfig
    from repro_torch.engine import MemoryStore, RetrievalEngine
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    device = torch.device(device)
    program = program or Port()
    cfg = model_config(config)
    ds = config["datastore"]
    if ds["centres"] * ds["keys_per_centre"] != ds["capacity"]:
        raise ValueError("knnlm: centres x keys_per_centre != capacity")
    B, pos = traffic["batch"], traffic["position"]
    t0 = time.perf_counter()
    # a run before this one in the process (the control's seeds) leaves
    # its blocks cached; blocks reused piecemeal would keep the store's
    # transient from fitting
    _free(device)
    with torch.no_grad():
        params = transformer.init(_gen(device, _sub(seed, 1)), cfg)
        load(params, cfg, config, seed, device)
        program.prepare(params)
        caches = _cache(cfg, config, seed, B, pos, device)
        centres = _centres(cfg, params, caches, ds, seed, B, pos, device)
        # the empty store's creation takes a transient of several times
        # its size: it is made while the cache is away, and the cache's
        # seeded rows are drawn again after
        del caches
        _free(device)
        search = SearchConfig(encoding=ds["encoding"], cl=ds["cl"],
                              mode=ds["mode"], mcam=MCAMConfig(**ds["mcam"]),
                              noisy=ds["noisy"])
        mem = MemoryConfig(capacity=ds["capacity"], dim=ds["dim"],
                           search=search, clip_std=ds["clip_std"])
        x, labels = _keys(config, centres, seed, device)
        store = MemoryStore.create(mem, device).calibrate(x)
        for r0 in range(0, x.shape[0], ds["program_rows"]):
            store = store.write(x[r0:r0 + ds["program_rows"]],
                                labels[r0:r0 + ds["program_rows"]])
        del x, labels
        _free(device)
        caches = _cache(cfg, config, seed, B, pos, device)
    engine = _Recording(RetrievalEngine(search))
    taps: list = []
    step = steps.make_serve_step_with_mcam(
        cfg, mem, lam=config["lam"], engine=engine, k=traffic["k"],
        mode=traffic["mode"], inplace=True, taps=taps)
    _log(f"model of {cfg.n_layers} layers, cache of {B} sequences at "
         f"position {pos} and a datastore of {ds['capacity']} keys in "
         f"{time.perf_counter() - t0:.3f} s")
    return State(config, traffic, cfg, params, caches, store, step, engine,
                 taps, _gen(device, _sub(seed, 6)), centres, seed)


# -- serving -----------------------------------------------------------------


def issue(state: State, no: int, span) -> tuple:
    """One serve step of `batch` sequences at `position` -> (tokens
    counted, the mixture's argmax tokens to copy home, the tensors the
    check keeps, the step's number since set-up)."""
    t = state.traffic
    tokens = torch.randint(0, state.cfg.vocab_size, (t["batch"], 1),
                           generator=state.tokens,
                           device=state.centres.device)
    with torch.no_grad(), span(SEARCH_SPAN):
        mixed, state.caches = state.step(state.params, state.caches,
                                         {"tokens": tokens}, t["position"],
                                         state.store)
        best = mixed[:, 0].argmax(-1)
    state.issued += 1
    _, res = state.engine.last
    kept = {"tokens": tokens, "mixed": mixed[:, 0], "votes": res.votes,
            "dist": res.dist, "indices": res.indices, "labels": res.labels}
    for i, tap in enumerate(state.taps):
        for name, v in tap.items():
            kept[f"{name}{i}"] = v
    return t["batch"], best, kept, state.issued - 1


def deliver(home: torch.Tensor) -> np.ndarray:
    return home.numpy().copy()


def replay(state: State, seed: int, device) -> list:
    """Every step's tokens drawn again from the seed."""
    g = _gen(torch.device(device), _sub(seed, 6))
    return [torch.randint(0, state.cfg.vocab_size,
                          (state.traffic["batch"], 1), generator=g,
                          device=device) for _ in range(state.issued)]


def held_pairs(config: dict, kept: dict) -> tuple[int, int]:
    """(routed (token, held expert) pairs, the most one held expert took
    in one layer) of one step, from the router's choice the decode's taps
    keep, summed / maxed over the MoE layers."""
    first, held = config["first_expert"], config["experts_held"]
    pairs = most = 0
    for layer in range(config["num_hidden_layers"]):
        if not reference.layer_is_moe(config, layer):
            continue
        rel = kept[f"experts{layer}"].flatten() - first
        rel = rel[(rel >= 0) & (rel < held)]
        pairs += rel.numel()
        most = max(most, int(torch.bincount(rel, minlength=held).max()))
    return pairs, most


# -- the check ---------------------------------------------------------------


class _Err:
    """sum of squared differences over sum of squares of the reference."""

    def __init__(self):
        self.num = self.den = 0.0

    def add(self, got: torch.Tensor, want: torch.Tensor) -> None:
        got, want = got.float(), want.float()
        self.num += float(((got - want) ** 2).sum())
        self.den += float((want ** 2).sum())

    def value(self) -> float:
        return math.sqrt(self.num / self.den) if self.den else 0.0


def _diff(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(b.device, b.dtype) != b).sum())


def check(state: State, tokens: list, sampled: dict, device) -> dict:
    """The numbers of the module docstring for one run. tokens: every
    step's tokens drawn again; sampled: {batch no: (the kept tensors, the
    delivered tokens, the step's number since set-up)}."""
    reference.precise()
    device = torch.device(device)
    config, traffic, cfg = state.config, state.traffic, state.cfg
    B, pos = traffic["batch"], traffic["position"]
    out = dict.fromkeys(NUMBERS, 0)
    batches = sorted(sampled)
    for no in batches:
        if not torch.equal(sampled[no][0]["tokens"], tokens[sampled[no][2]]):
            raise RuntimeError("bench: the seed did not give the same "
                               "tokens twice")
    state.params = None
    _free(device)
    with torch.no_grad():
        table = reference.rope_table(config, device)
        eps = config["rms_norm_eps"]
        errs = {name: [] for name in ("attn", "ffn", "stream")}
        routed = near = 0
        for layer, (g, i) in enumerate(_layer_slots(cfg)):
            p = layer_weights(config, state.seed, layer, device)
            is_moe = reference.layer_is_moe(config, layer)
            attn, ffn, stream = _Err(), _Err(), _Err()
            cache = state.caches[g]
            for j, b0 in enumerate(range(0, B, PREFIX_BLOCK)):
                rows = min(PREFIX_BLOCK, B - b0)
                ckv, krope = _seed_rows(config, state.seed, layer, j, rows,
                                        pos, device)
                sl = slice(b0, b0 + rows)
                out["cache_wrong"] += (
                    _diff(cache["ckv"][i, sl, :pos], ckv)
                    + _diff(cache["krope"][i, sl, :pos], krope))
                ckv, krope = ckv.float(), krope.float()
                for no in batches:
                    got = sampled[no][0]
                    x = got[f"x{layer}"][sl, 0]
                    want = reference.attention_block(
                        p, x, ckv, krope, pos, config, table) - x.float()
                    attn.add(got[f"attn{layer}"][sl, 0], want)
            out["cache_wrong"] += _diff(
                cache["kpos"][i, :pos], torch.arange(pos, device=device))
            for no in batches:
                got = sampled[no][0]
                x, y = got[f"x{layer}"][:, 0], got[f"attn{layer}"][:, 0]
                h, f = got[f"ffn_in{layer}"][:, 0], got[f"ffn{layer}"][:, 0]
                mid = x.float() + y.float()
                stream.add(h, reference.rms_norm(mid, p["norm2"]["scale"],
                                                 eps))
                stream.add(got[f"x{layer + 1}"][:, 0], mid + f.float())
                r, ok = None, torch.ones(B, dtype=torch.bool, device=device)
                if is_moe:
                    r = reference.route(h, p["moe"]["router"],
                                        p["moe"]["bias"], config)
                    same = (got[f"experts{layer}"].sort(-1).values
                            == r["experts"].sort(-1).values).all(-1)
                    tie = r["margin"] < ROUTER_MARGIN
                    out["router_wrong"] += int((~same & ~tie).sum())
                    routed += B
                    near += int(tie.sum())
                    ok = same
                want = reference.ffn(p, h, config, is_moe, r)
                ffn.add(f[ok], want[ok])
            errs["attn"].append(attn.value())
            errs["ffn"].append(ffn.value())
            errs["stream"].append(stream.value())
            del p
        out["attn_err"] = max(errs["attn"])
        out["ffn_err"] = max(errs["ffn"])
        out["stream_err"] = max(errs["stream"])
        out["router_near_tie_pct"] = 100.0 * near / max(routed, 1)
        _log("relative errors by layer: attn "
             + " ".join(f"{e:.5f}" for e in errs["attn"]) + "; ffn "
             + " ".join(f"{e:.5f}" for e in errs["ffn"]))
        state.caches = None
        _free(device)
        head = {name: top_weight(config, state.seed, name, device)
                for name in ("final_norm", "unembed")}
        _check_head(state, sampled, batches, head, out, device)
    counts = [held_pairs(config, sampled[no][0]) for no in batches]
    if counts:
        _log(f"held experts: {sum(c[0] for c in counts) / len(counts):.1f} "
             f"routed pairs a checked step, at most "
             f"{max(c[1] for c in counts)} for one expert in one layer")
    return out


def _check_head(state: State, sampled: dict, batches: list, head: dict,
                out: dict, device) -> None:
    """The head's search bit for bit and the mixture, on the program's
    final hidden rows."""
    config, traffic = state.config, state.traffic
    ds = config["datastore"]
    x, labels = _keys(config, state.centres, state.seed, device)
    ref = mcam.Store(ds, device)
    ref.calibrate(x)
    ref.write(x, labels)
    del x, labels
    worst = 0.0
    n_layers = config["num_hidden_layers"]
    for no in batches:
        got, delivered, _ = sampled[no]
        hidden = got[f"x{n_layers}"][:, 0]
        r = reference.knn_search(hidden, ref, ds["dim"], traffic["k"])
        out["query_words_wrong"] += _diff(
            state.store.quantize_queries(hidden[:, :ds["dim"]]), r["words"])
        for name, have, want in (("rows_wrong", "indices", "rows"),
                                 ("dist_wrong", "dist", "dist"),
                                 ("votes_wrong", "votes", "votes"),
                                 ("labels_wrong", "labels", "labels")):
            out[name] += _diff(got[have], r[want])
        lm = reference.logits(head, hidden, config)
        mixed = reference.mixture(lm, r["votes"], r["labels"], config["lam"])
        worst = max(worst, float((got["mixed"] - mixed).abs().max()))
        top = mixed.topk(2, -1)
        clear = (top.values[:, 0] - top.values[:, 1]) > TOKEN_MARGIN
        wrong = torch.as_tensor(delivered, device=device) != top.indices[:, 0]
        out["tokens_wrong"] += int((wrong & clear).sum())
    out["mixture_err"] = worst


# -- sizes and work ----------------------------------------------------------


def dry(config: dict, traffic: dict) -> tuple[dict, dict]:
    """The cell at a size the CPU runs in seconds: the published router
    and YaRN at the port's smoke widths (16 experts, 4 held from expert
    4), 3 layers, 16 cached positions, batches of 4, k 8, a datastore of
    1,024 keys (the fused shortlist's threshold, so that the search takes
    the main path's route)."""
    from repro_torch.configs import deepseek_v3_671b as v3
    small = _published(v3.get_published_smoke_config(4, 4))
    ds = dict(config["datastore"], capacity=1024, centres=16,
              keys_per_centre=64, program_rows=512)
    config = dict(config, **small, smoke=True, datastore=ds)
    traffic = dict(traffic, batch=4, position=16, k=min(traffic["k"], 8))
    return config, traffic


def size(config: dict, traffic: dict) -> dict:
    return {"layers": config["num_hidden_layers"],
            "experts_held": config["experts_held"],
            "batch": traffic["batch"], "position": traffic["position"],
            "keys": config["datastore"]["capacity"]}


def work(config: dict, traffic: dict) -> dict[str, dict]:
    """The bounds of what one step drives: the whole step (`decode`), one
    layer's attention (`mla`) and held-expert FFN (`moe`), and the head's
    search (bench/work.py's `shortlist` and `rescore`)."""
    b, t = traffic["batch"], traffic["position"]
    ds = config["datastore"]
    s, sl = yardstick.strings(ds), ds["mcam"]["string_len"]
    return {"decode": work_lm.decode_step(config, b, t),
            "mla": work_lm.mla(config, b, t),
            "moe": work_lm.moe(config, b),
            "shortlist": yardstick.shortlist(b, ds["capacity"], ds["dim"],
                                             traffic["k"]),
            "rescore": yardstick.rescore(b, traffic["k"], s, sl)}


def _log(msg: str) -> None:
    print(f"bench: {msg}", file=sys.stderr, flush=True)
