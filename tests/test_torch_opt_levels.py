"""The reference's `REPRO_OPT` levels in the port, against the JAX
package, on the CPU.

Both packages read `REPRO_OPT` when their modules are imported, so one
subprocess with `REPRO_OPT=6` (every level on) and 8 forced host devices
imports both and writes what each computes (`LEVELS_SIDE`):

- level 1: the embeddings shard by vocab only (`logical_for`, and the
  embedding leaves' specs on a (2, 2, 2) mesh);
- level 3: decode steps take `decode_rules` (`rules_for`);
- level 4: the norm multiplies in the compute dtype (`apply_norm` on bf16
  inputs, layer and RMS norms), held within BF16_NORM_ATOL; levels 2 and
  5 change no value, so a float32 forward and decode step of a smoke
  model with every level on stay within F32_TOL of JAX's;
- level 6: `adapt_config` turns attention chunking off for training at
  <= 4,096 positions, and only there.

This process (no `REPRO_OPT`) checks that the level-0 values differ
where the levels say they should.
"""

import json
import os
import subprocess
import sys

import pytest

from repro_torch.configs import load_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import steps as S
from repro_torch.models import layers as L

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# bf16 products of the level-4 norm, one rounding apart per op in the two
# packages: test_torch_lm.py's BF16_LOGIT_ATOL
BF16_NORM_ATOL = 0.0625
F32_TOL = 2e-5
NORM_ARCHS = ("starcoder2-3b", "llama3-405b")          # layernorm, rmsnorm
CHUNK_SHAPES = {"train_4k": ("train", 4096), "train_8k": ("train", 8192),
                "prefill_4k": ("prefill", 4096), "decode": ("decode", 4096)}

LEVELS_SIDE = r'''
import dataclasses, json, sys
import jax, jax.numpy as jnp, numpy as np
import torch
from repro import configs as JC
from repro.launch import steps as JS
from repro.models import layers as JL, transformer as JT
from repro.models.sharding import rules_for_mesh as j_rules_for_mesh
from repro_torch import configs as TC
from repro_torch.configs.base import ShapeConfig as TShape
from repro_torch.launch import steps as TS
from repro_torch.launch.mesh import Mesh
from repro_torch.models import layers as TL, transformer as TT
from repro_torch.models.sharding import rules_for_mesh as t_rules_for_mesh

NORM_ARCHS, CHUNKS = json.loads(sys.argv[2]), json.loads(sys.argv[3])
out = {"levels": [JL._OPT, JS.OPT_LEVEL, TL.OPT_LEVEL, TS.OPT_LEVEL]}
rules = lambda r: {f: list(getattr(r, f)) for f in
                   ("batch", "fsdp", "tensor", "expert", "seq")}
spec = lambda s: [e if e is None or isinstance(e, str) else list(e)
                  for e in s]
jmesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"))
tmesh = Mesh.repeat("cpu", (2, 2, 2), ("pod", "data", "model"))
out["logical"] = {n: [list(JL.logical_for(n, 2)), list(TL.logical_for(n, 2))]
                  for n in ("embed", "unembed")}
out["embed_specs"] = {}
for arch in ("starcoder2-3b", "llama3-405b"):
    jc, tc = JC.load_config(arch), TC.load_config(arch)
    js = JS.param_shardings(jc, jmesh, j_rules_for_mesh(jmesh))
    ts = TS.param_shardings(tc, tmesh, t_rules_for_mesh(tmesh))
    out["embed_specs"][arch] = {k: [spec(js[k].spec), spec(ts[k].spec)]
                                for k in ("embed", "unembed") if k in js}
out["rules_for"] = {}
for kind in ("train", "prefill", "decode"):
    out["rules_for"][kind] = [
        rules(JS.rules_for(jmesh, JC.ShapeConfig("s", 64, 8, kind))),
        rules(TS.rules_for(tmesh, TShape("s", 64, 8, kind)))]
out["attn_chunk"] = {}
for arch in ("starcoder2-3b", "deepseek-v3-671b"):
    for name, (kind, seq) in CHUNKS.items():
        jcfg = JS.adapt_config(JC.load_config(arch),
                               JC.ShapeConfig("s", seq, 8, kind), 1)
        tcfg = TS.adapt_config(TC.load_config(arch),
                               TShape("s", seq, 8, kind), 1)
        out["attn_chunk"][arch + "/" + name] = [jcfg.attn_chunk,
                                                tcfg.attn_chunk]

def t_of(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())

rng = np.random.default_rng(0)
out["norm"] = {}
for arch in NORM_ARCHS:
    cfg = JC.load_config(arch, smoke=True)
    tcfg = TC.load_config(arch, smoke=True)
    D = cfg.d_model
    x = jnp.asarray(rng.standard_normal((2, 5, D)) * 3, jnp.bfloat16)
    p = {"scale": jnp.asarray(1 + rng.standard_normal(D) * 0.1,
                              jnp.float32)}
    if cfg.norm == "layernorm":
        p["nbias"] = jnp.asarray(rng.standard_normal(D) * 0.1, jnp.float32)
    want = jax.jit(lambda p, x: JL.apply_norm(p, x, cfg))(p, x)
    got = TL.apply_norm({k: t_of(v) for k, v in p.items()}, t_of(x), tcfg)
    out["norm"][arch] = {
        "dtype": str(got.dtype),
        "max_abs": float(np.max(np.abs(got.float().numpy()
                                       - np.asarray(want, np.float32)))),
        "scale": float(np.max(np.abs(np.asarray(want, np.float32))))}

# a float32 smoke model with every level on: forward and one decode step
out["model"] = {}
for arch in NORM_ARCHS:
    cfg = dataclasses.replace(JC.load_config(arch, smoke=True),
                              dtype="float32", param_dtype="float32")
    tcfg = dataclasses.replace(TC.load_config(arch, smoke=True),
                               dtype="float32", param_dtype="float32")
    jp = JT.init(jax.random.PRNGKey(0), cfg)
    tp = TT.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                              "cpu")
    toks = rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    jl, _ = jax.jit(lambda p, b: JT.forward(p, cfg, b))(
        jp, {"tokens": jnp.asarray(toks)})
    tl, _ = TT.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    jc = JT.init_cache(cfg, 2, 8)
    tcache = TT.init_cache(tcfg, 2, 8, device="cpu")
    jd, _ = jax.jit(lambda p, b, c: JT.decode_step(p, cfg, b, c, 0))(
        jp, {"tokens": jnp.asarray(toks[:, :1])}, jc)
    td, _ = TT.decode_step(tp, tcfg, {"tokens": torch.from_numpy(toks[:, :1])},
                           tcache, 0)
    out["model"][arch] = {
        "forward": float(np.max(np.abs(tl.detach().numpy() - np.asarray(jl)))),
        "forward_scale": float(np.max(np.abs(np.asarray(jl)))),
        "decode": float(np.max(np.abs(td.detach().numpy() - np.asarray(jd)))),
        "decode_scale": float(np.max(np.abs(np.asarray(jd))))}
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
'''


@pytest.fixture(scope="module")
def levels(tmp_path_factory):
    """Both packages with REPRO_OPT=6, from one subprocess."""
    path = tmp_path_factory.mktemp("levels") / "levels.json"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["REPRO_OPT"] = "6"
    proc = subprocess.run(
        [sys.executable, "-c", LEVELS_SIDE, str(path),
         json.dumps(NORM_ARCHS), json.dumps(CHUNK_SHAPES)],
        capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(path) as f:
        return json.load(f)


def test_level_is_read_when_imported(levels):
    assert levels["levels"] == [6, 6, 6, 6]
    assert L.OPT_LEVEL == S.OPT_LEVEL == 0


def test_level_1_embeddings_shard_by_vocab_only(levels):
    for name, (want, got) in levels["logical"].items():
        assert got == want, name
    assert levels["logical"]["embed"][1] == ["tensor", None]
    assert levels["logical"]["unembed"][1] == [None, "tensor"]
    assert list(L.logical_for("embed", 2)) == ["tensor", "fsdp"]
    for arch, specs in levels["embed_specs"].items():
        for leaf, (want, got) in specs.items():
            assert got == want, (arch, leaf)
            assert got.count(None) == 1, (arch, leaf, got)


def test_level_3_decode_takes_decode_rules(levels):
    for kind, (want, got) in levels["rules_for"].items():
        assert got == want, kind
    assert levels["rules_for"]["decode"][1] == {
        "batch": [], "fsdp": ["pod", "data"], "tensor": ["model"],
        "expert": ["model"], "seq": ["pod", "data", "model"]}
    assert levels["rules_for"]["train"][1]["batch"] == ["pod", "data"]


def test_level_4_norm_multiplies_in_the_compute_dtype(levels):
    for arch, r in levels["norm"].items():
        assert r["dtype"] == "torch.bfloat16", arch
        assert r["max_abs"] <= BF16_NORM_ATOL, (arch, r)


def test_every_level_keeps_the_model_within_f32_tolerance(levels):
    """Levels 2 and 5 are layouts; level 4's products in float32 round as
    level 0's: a float32 forward and decode step with every level on
    stay within F32_TOL (relative to the logits' scale) of JAX's."""
    for arch, r in levels["model"].items():
        assert r["forward"] <= F32_TOL * max(1.0, r["forward_scale"]), r
        assert r["decode"] <= F32_TOL * max(1.0, r["decode_scale"]), r


def test_level_6_turns_chunking_off_for_short_training(levels):
    for key, (want, got) in levels["attn_chunk"].items():
        assert got == want, key
        kind = key.split("/")[1]
        arch = key.split("/")[0]
        base = load_config(arch).attn_chunk
        assert got == (0 if kind == "train_4k" else base), (key, got)
        # at level 0 (this process) chunking stays as configured
        k, seq = CHUNK_SHAPES[kind]
        assert S.adapt_config(load_config(arch), ShapeConfig(
            "s", seq, 8, k), 1).attn_chunk == base
