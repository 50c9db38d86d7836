"""Parity of the port's sharding layer (`repro_torch.models.sharding`,
the sharding trees of `launch/steps.py`, `runtime/pipeline.py`) with the
JAX package, on the CPU, and the placed train steps against the
unplaced ones.

The JAX side runs once, in a module-scoped subprocess with 8 forced host
devices (`JAX_SIDE`): for every LM arch of `configs.ARCHS` at smoke and
at full width (abstract shapes) on the meshes (2, 2, 2) pod / data /
model, (4, 2) and (8, 1) data / model, it writes the rules, every leaf's
logical axes and spec (`param_shardings`; `opt_shardings` for adamw, its
bf16-state variant and adafactor; `cache_shardings` under
`rules_for_mesh` and `decode_rules`; `input_specs` for train, prefill and
decode), and each distinct (mesh, spec, shape)'s `devices_indices_map`,
position by position. It also writes the HAT trainer's `place` layouts,
the pipeline's output on the reference test's (4,) mesh, and what the
reference's own sharded train step raises on this JAX (ROADMAP C.R9: the
embedding gather on a sharded table raises `ShardingTypeError`; it is
pinned as a fact about the reference, not used as an anchor). Every spec
and index slice must equal JAX's exactly; the pipeline within 2e-5.

The port's meshes are meshes of positions on the CPU
(`Mesh.repeat("cpu", ...)`). Its placed train step (starcoder2-3b,
deepseek-moe-16b and xlstm-350m smoke; adamw block by block, adafactor,
adamw8bit and the int8 codec assembled; 3 steps on one batch) and placed
HAT meta step must equal the unplaced steps bit for bit (the unplaced LM
step is held to JAX's in tests/test_torch_train_step.py), and
`train(model_parallel=2)` must equal `model_parallel=1` in both
packages.
"""

import functools
import json
import math
import os
import signal
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.launch import train as j_train
from repro_torch import tree as tree_lib
from repro_torch.configs import load_config
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.launch import steps as S
from repro_torch.launch import train as t_train
from repro_torch.launch.mesh import Mesh, make_host_mesh
from repro_torch.models import layers as L
from repro_torch.models import transformer as tfm
from repro_torch.models.sharding import (NamedSharding, P, Placed, Rules,
                                         active_mesh, aconstrain, constrain,
                                         legalize_spec, place, rules_for_mesh)
from repro_torch.runtime.pipeline import pipeline_apply

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"2x2x2": ((2, 2, 2), ("pod", "data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "8x1": ((8, 1), ("data", "model"))}
LM_ARCHS = [a for a in j_configs.ARCHS
            if isinstance(j_configs.load_config(a, smoke=True),
                          j_configs.ModelConfig)]
WIDTHS = {"smoke": True, "full": False}
OPTIMIZERS = {"adamw": ("adamw", {}),
              "adamw_bf16": ("adamw", {"state_dtype": "bfloat16"}),
              "adafactor": ("adafactor", {})}
CACHE_SHAPES = ("decode_32k", "long_500k")
PIPE = {"S": 4, "M": 6, "mb": 3, "d": 8}
PIPE_TOL = 2e-5
# the HAT trainer's place: (mesh shape, axis names, data axes)
HAT_MESHES = {"8": ((8,), ("data",), ("data",)),
              "4x2": ((4, 2), ("data", "model"), ("data",)),
              "4x2-both": ((4, 2), ("data", "model"), ("data", "model"))}
HAT_LEAVES = {"support_images": (24, 4, 4, 1), "support_labels": (24,),
              "query_images": (12, 4, 4, 1), "query_labels": (12,),
              "odd": (6, 3), "scalar": ()}

JAX_SIDE = r'''
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import configs as C
from repro.launch import steps as S
from repro.models import layers as L, transformer as tfm
from repro.models.sharding import rules_for_mesh
from repro.optim import make_optimizer

MESHES = json.loads(sys.argv[2])
ARCHS, WIDTHS = json.loads(sys.argv[3]), json.loads(sys.argv[4])
OPTS, CACHES = json.loads(sys.argv[5]), json.loads(sys.argv[6])
PIPE, HAT = json.loads(sys.argv[7]), json.loads(sys.argv[8])
HAT_LEAVES = json.loads(sys.argv[9])
meshes = {k: jax.make_mesh(tuple(v[0]), tuple(v[1]))
          for k, v in MESHES.items()}
maps = {}

def spec_json(spec):
    return [e if e is None or isinstance(e, str) else list(e) for e in spec]

def name(path):
    return "//".join(str(getattr(k, "key", getattr(k, "idx", None)))
                     for k in path)

def record(mname, sharding, shape):
    spec = spec_json(sharding.spec)
    key = json.dumps([mname, spec, list(shape)])
    if key not in maps:
        m = sharding.devices_indices_map(tuple(shape))
        maps[key] = [[None if s == slice(None) else [s.start, s.stop]
                      for s in m[d]] for d in meshes[mname].devices.flat]
    return spec

def specs(mname, tree, structs=None):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    shapes = (None if structs is None else
              [x.shape for x in jax.tree_util.tree_leaves(structs)])
    out = {}
    for i, (path, sh) in enumerate(flat):
        shape = shapes[i] if shapes is not None else sh.shape
        out[name(path)] = record(mname, sh if shapes is not None
                                 else sh.sharding, shape)
    return out

def rules_json(r):
    return {f: list(getattr(r, f))
            for f in ("batch", "fsdp", "tensor", "expert", "seq")}

out = {"rules": {}, "archs": {}}
for mname, mesh in meshes.items():
    out["rules"][mname] = {
        "default": rules_json(rules_for_mesh(mesh)),
        "seq": rules_json(rules_for_mesh(mesh, seq_sharding=True)),
        "decode": rules_json(S.decode_rules(mesh))}
for arch in ARCHS:
    for wname, smoke in WIDTHS.items():
        cfg = C.load_config(arch, smoke=smoke)
        aps = tfm.abstract_params(cfg)
        flat = jax.tree_util.tree_flatten_with_path(aps)[0]
        rec = {"abstract": {name(p): [list(a.shape), str(a.dtype)]
                            for p, a in flat},
               "logical": {name(p): list(L.logical_for(
                   str(p[-1].key), a.ndim)) for p, a in flat}}
        opt_shapes = {}
        for oname, (opt, kw) in OPTS.items():
            kw = {k: jnp.dtype(v) for k, v in kw.items()}
            opt_shapes[oname] = jax.eval_shape(
                make_optimizer(opt, 1e-3, **kw).init, aps)
        for mname, mesh in meshes.items():
            rules = rules_for_mesh(mesh)
            ps = S.param_shardings(cfg, mesh, rules)
            m = {"params": specs(mname, ps, aps), "opt": {}, "cache": {},
                 "inputs": {}}
            for oname, shapes in opt_shapes.items():
                m["opt"][oname] = specs(mname, S.opt_shardings(
                    shapes, aps, ps, mesh, rules), shapes)
            for cname in CACHES:
                shp = C.SHAPES[cname]
                for rname, r in (("default", rules),
                                 ("decode", S.decode_rules(mesh))):
                    sh, cabs = S.cache_shardings(cfg, shp.global_batch,
                                                 shp.seq_len, mesh, r)
                    m["cache"][cname + "/" + rname] = {
                        "specs": specs(mname, sh, cabs),
                        "shapes": {name(p): list(a.shape) for p, a in
                                   jax.tree_util.tree_flatten_with_path(
                                       cabs)[0]}}
            for sname, shp in C.SHAPES.items():
                ins = S.input_specs(cfg, shp, mesh, S.rules_for(mesh, shp))
                m["inputs"][sname] = {
                    k: [list(v.shape), str(v.dtype),
                        record(mname, v.sharding, v.shape)]
                    for k, v in ins.items()}
            rec[mname] = m
        out["archs"][arch + "/" + wname] = rec

# the HAT trainer's place, leaf by leaf
from repro.core.avss import SearchConfig
from repro.core.hat import HATConfig
from repro.optim import adamw
hat_cfg = HATConfig(search=SearchConfig("mtmc", cl=2, mode="avss",
                                        use_kernel="ref"))
out["hat"] = {}
for hname, (shape, names, axes) in HAT.items():
    mesh = jax.make_mesh(tuple(shape), tuple(names))
    meshes["hat" + hname] = mesh
    _, _, place = S.make_hat_train_steps(
        lambda p, x: x, hat_cfg, adamw(1e-3), n_way=2, mesh=mesh,
        data_axes=tuple(axes))
    placed = place({k: np.zeros(v, np.float32)
                    for k, v in HAT_LEAVES.items()})
    out["hat"][hname] = {k: record("hat" + hname, v.sharding, v.shape)
                         for k, v in placed.items()}

# the pipeline on the reference test's (4,) mesh
from repro.runtime.pipeline import pipeline_apply
pmesh = jax.make_mesh((4,), ("pipe",), devices=jax.devices()[:4])
keys = jax.random.split(jax.random.PRNGKey(0), PIPE["S"])
Ws = jnp.stack([jax.random.normal(k, (PIPE["d"], PIPE["d"]))
                / np.sqrt(PIPE["d"]) for k in keys])
x = jax.random.normal(jax.random.PRNGKey(1),
                      (PIPE["M"], PIPE["mb"], PIPE["d"]))
y = pipeline_apply(lambda W, h: jnp.tanh(h @ W), Ws, x, pmesh, axis="pipe")
out["pipeline"] = {"Ws": np.asarray(Ws).tolist(),
                   "x": np.asarray(x).tolist(), "y": np.asarray(y).tolist()}

# the reference's own sharded train step on (2, 2, 2) (a fact, C.R9)
from repro.configs.base import TrainConfig
from repro.models.sharding import active_mesh
mesh = meshes["2x2x2"]
rules = rules_for_mesh(mesh)
cfg = C.load_config("starcoder2-3b", smoke=True)
try:
    with mesh, active_mesh(mesh, rules):
        step, opt = S.make_train_step(cfg, TrainConfig(learning_rate=1e-3),
                                      rules)
        params = jax.tree_util.tree_map(
            jax.device_put, tfm.init(jax.random.PRNGKey(0), cfg),
            S.param_shardings(cfg, mesh, rules))
        b = {"tokens": jnp.zeros((2, 4, 16), jnp.int32),
             "labels": jnp.zeros((2, 4, 16), jnp.int32)}
        jax.jit(step)(params, opt.init(params), b)
    out["sharded_step"] = "ran"
except Exception as e:
    out["sharded_step"] = type(e).__name__ + ": " + str(e)[:200]
out["maps"] = maps
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
'''


@pytest.fixture(scope="module")
def jside(tmp_path_factory):
    """The JAX package's side, from one subprocess (module docstring)."""
    path = tmp_path_factory.mktemp("jax_side") / "jax.json"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env.pop("REPRO_OPT", None)
    args = [json.dumps(a) for a in (
        {k: [list(v[0]), list(v[1])] for k, v in MESHES.items()}, LM_ARCHS,
        WIDTHS, OPTIMIZERS, CACHE_SHAPES, PIPE,
        {k: [list(v[0]), list(v[1]), list(v[2])]
         for k, v in HAT_MESHES.items()},
        {k: list(v) for k, v in HAT_LEAVES.items()})]
    proc = subprocess.run([sys.executable, "-c", JAX_SIDE, str(path), *args],
                          capture_output=True, text=True, timeout=600,
                          env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(path) as f:
        return json.load(f)


def _mesh(name: str) -> Mesh:
    shape, names = MESHES[name]
    return Mesh.repeat("cpu", shape, names)


def _spec_json(spec) -> list:
    return [e if e is None or isinstance(e, str) else list(e) for e in spec]


def _map_json(sharding: NamedSharding, shape) -> list:
    m = sharding.devices_indices_map(tuple(shape))
    return [[None if s == slice(None) else [s.start, s.stop] for s in m[pos]]
            for pos in np.ndindex(sharding.mesh.devices.shape)]


def _assert_specs(jside, mname: str, jspecs: dict, shardings, structs,
                  ctx: str) -> None:
    """Each leaf's spec equals JAX's, and each position's index slices
    equal JAX's `devices_indices_map` of the same (mesh, spec, shape)."""
    names, shs = tree_lib.flatten_with_names(shardings)
    shapes = [tuple(x.shape) for x in tree_lib.leaves(structs)]
    assert sorted(names) == sorted(jspecs), (ctx, names, list(jspecs))
    for n, sh, shape in zip(names, shs, shapes):
        spec = _spec_json(sh.spec)
        assert spec == jspecs[n], (ctx, n, spec, jspecs[n])
        key = json.dumps([mname, spec, list(shape)])
        assert _map_json(sh, shape) == jside["maps"][key], (ctx, n)


@functools.cache
def _abstract(arch: str, smoke: bool):
    cfg = load_config(arch, smoke=smoke)
    return cfg, tfm.abstract_params(cfg)


@functools.cache
def _param_shardings(arch: str, smoke: bool, mname: str):
    mesh = _mesh(mname)
    cfg = _abstract(arch, smoke)[0]
    return mesh, S.param_shardings(cfg, mesh, rules_for_mesh(mesh))


def _rules_json(r: Rules) -> dict:
    return {f: list(getattr(r, f))
            for f in ("batch", "fsdp", "tensor", "expert", "seq")}


# -- rules, logical axes, specs and index maps --------------------------------


@pytest.mark.parametrize("mname", list(MESHES))
def test_rules_match_jax(jside, mname):
    mesh = _mesh(mname)
    want = jside["rules"][mname]
    assert _rules_json(rules_for_mesh(mesh)) == want["default"]
    assert _rules_json(rules_for_mesh(mesh, seq_sharding=True)) == want["seq"]
    assert _rules_json(S.decode_rules(mesh)) == want["decode"]
    # at level 0 rules_for is rules_for_mesh for every kind of step
    for shape in j_configs.SHAPES.values():
        assert S.rules_for(mesh, shape) == rules_for_mesh(mesh)


def test_resolve_and_legalize_match_jax():
    """`Rules.resolve` and `legalize_spec` against JAX's on every logical
    tuple of the parameter and cache tables, over shapes that do and do
    not divide."""
    from jax.sharding import PartitionSpec as JP
    from repro.launch import steps as JS
    from repro.models import layers as JL
    from repro.models import sharding as JSh
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    logicals = {tuple(lg) for _, lg in JL.PARAM_LOGICAL}
    logicals |= {tuple(lg) for lg in JS._CACHE_LOGICAL.values()}
    mesh = Mesh.repeat("cpu", (1, 1), ("data", "model"))
    for kw in ({}, {"batch": ("pod", "data"), "fsdp": ("pod", "data"),
                    "seq": ("data", "model")}, {"tensor": ()}):
        jr, tr = JSh.Rules(**kw), Rules(**kw)
        for lg in logicals:
            assert tuple(tr.resolve(*lg)) == tuple(jr.resolve(*lg)), lg
    for spec in (P("data", None, "model"), P(("data", "model")), P(),
                 P(None, "model")):
        jspec = JP(*spec)
        for shape in ((4, 6, 2), (3, 5, 7), (8,), (2, 2, 2, 2)):
            if len(spec) > len(shape):
                continue
            got = legalize_spec(spec, shape, mesh)
            want = JSh.legalize_spec(jspec, shape, jmesh)
            assert tuple(got) == tuple(want) + (None,) * (
                len(shape) - len(want)), (spec, shape)


@pytest.mark.parametrize("wname", list(WIDTHS))
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_abstract_params_and_logical_axes_match_jax(jside, arch, wname):
    """`abstract_params` (meta tensors: no storage, at full width too)
    has JAX's leaves, shapes and dtypes; `logical_for` names each leaf's
    axes as JAX's does."""
    cfg, aps = _abstract(arch, WIDTHS[wname])
    rec = jside["archs"][f"{arch}/{wname}"]
    names, leaves = tree_lib.flatten_with_names(aps)
    assert sorted(names) == sorted(rec["abstract"])
    for n, a in zip(names, leaves):
        assert a.device.type == "meta"
        assert [list(a.shape), str(a.dtype).replace("torch.", "")] == \
            rec["abstract"][n], n
        assert list(L.logical_for(n.split("//")[-1], a.dim())) == \
            rec["logical"][n], n


@pytest.mark.parametrize("part", ["params", "opt", "cache", "inputs"])
@pytest.mark.parametrize("mname", list(MESHES))
@pytest.mark.parametrize("wname", list(WIDTHS))
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_sharding_trees_match_jax(jside, arch, wname, mname, part):
    """`param_shardings`, `opt_shardings` (three optimizers),
    `cache_shardings` (two cache shapes, two rule sets) and `input_specs`
    (every SHAPES entry): every spec and every position's index slices
    equal JAX's."""
    cfg, aps = _abstract(arch, WIDTHS[wname])
    mesh, ps = _param_shardings(arch, WIDTHS[wname], mname)
    rules = rules_for_mesh(mesh)
    want = jside["archs"][f"{arch}/{wname}"][mname]
    ctx = f"{arch}/{wname}/{mname}"
    if part == "params":
        _assert_specs(jside, mname, want["params"], ps, aps, ctx)
    elif part == "opt":
        for oname, (opt, kw) in OPTIMIZERS.items():
            kw = {k: getattr(torch, v) for k, v in kw.items()}
            from repro_torch.optim import make_optimizer
            shapes = make_optimizer(opt, 1e-3, **kw).init(aps)
            _assert_specs(jside, mname, want["opt"][oname], S.opt_shardings(
                shapes, aps, ps, mesh, rules), shapes, f"{ctx}/{oname}")
    elif part == "cache":
        for cname in CACHE_SHAPES:
            shp = j_configs.SHAPES[cname]
            for rname, r in (("default", rules),
                             ("decode", S.decode_rules(mesh))):
                sh, cabs = S.cache_shardings(cfg, shp.global_batch,
                                             shp.seq_len, mesh, r)
                w = want["cache"][f"{cname}/{rname}"]
                names, leaves = tree_lib.flatten_with_names(cabs)
                assert {n: list(a.shape) for n, a in zip(names, leaves)} \
                    == w["shapes"], (ctx, cname)
                _assert_specs(jside, mname, w["specs"], sh, cabs,
                              f"{ctx}/{cname}/{rname}")
    else:
        from repro_torch.configs import SHAPES
        for sname, shp in SHAPES.items():
            got = S.input_specs(cfg, shp, mesh, S.rules_for(mesh, shp))
            w = want["inputs"][sname]
            assert sorted(got) == sorted(w), (ctx, sname)
            for k, v in got.items():
                shape, dtype, spec = w[k]
                assert list(v.shape) == shape and str(v.dtype).replace(
                    "torch.", "") == dtype, (ctx, sname, k)
                assert _spec_json(v.sharding.spec) == spec, (ctx, sname, k)
                key = json.dumps([mname, spec, shape])
                assert _map_json(v.sharding, v.shape) == jside["maps"][key]


@pytest.mark.parametrize("hname", list(HAT_MESHES))
def test_hat_place_matches_jax(jside, hname):
    """`make_hat_train_steps(..., mesh)`'s `place` rows-or-replicates each
    leaf as JAX's does, with JAX's index slices."""
    from repro_torch.core.avss import SearchConfig
    from repro_torch.core.hat import HATConfig
    from repro_torch.optim import adamw
    shape, names, axes = HAT_MESHES[hname]
    mesh = Mesh.repeat("cpu", shape, names)
    _, _, place_fn = S.make_hat_train_steps(
        lambda p, x: x, HATConfig(search=SearchConfig("mtmc", cl=2)),
        adamw(1e-3), n_way=2, device="cpu", mesh=mesh, data_axes=axes)
    arrays = {k: np.arange(int(np.prod(v)), dtype=np.float64).reshape(v)
              for k, v in HAT_LEAVES.items()}
    placed = place_fn(arrays)
    for k, v in placed.items():
        assert isinstance(v, Placed) and v.dtype == torch.float32, k
        spec = _spec_json(v.sharding.spec)
        assert spec == jside["hat"][hname][k], (k, spec)
        key = json.dumps(["hat" + hname, spec, list(HAT_LEAVES[k])])
        assert _map_json(v.sharding, v.shape) == jside["maps"][key], k
        np.testing.assert_array_equal(v.full().numpy(), arrays[k])


def test_the_reference_sharded_step_raises_on_this_jax(jside):
    """ROADMAP C.R9: the reference's own train step with parameters placed
    by `param_shardings` on (2, 2, 2) raises ShardingTypeError in the
    embedding gather on this JAX, so it is no anchor; the port's placed
    step is held to the unplaced step instead."""
    assert jside["sharded_step"].startswith("ShardingTypeError"), \
        jside["sharded_step"]


# -- the pipeline -------------------------------------------------------------


def test_pipeline_matches_jax(jside):
    """`pipeline_apply` on a (4,) "pipe" mesh of positions, the reference
    test's stages (tanh(h @ W), S = 4, M = 6, mb = 3, d = 8) and data,
    within PIPE_TOL of JAX's; and bit for bit the sequential loop over
    each microbatch."""
    pj = jside["pipeline"]
    Ws = torch.tensor(pj["Ws"], dtype=torch.float32)
    x = torch.tensor(pj["x"], dtype=torch.float32)
    mesh = Mesh.repeat("cpu", (4,), ("pipe",))
    got = pipeline_apply(lambda W, h: torch.tanh(h @ W), Ws, x, mesh)
    np.testing.assert_allclose(got.numpy(), np.asarray(pj["y"], np.float32),
                               rtol=PIPE_TOL, atol=PIPE_TOL)
    seq = []
    for m in range(x.shape[0]):
        h = x[m]
        for i in range(Ws.shape[0]):
            h = torch.tanh(h @ Ws[i])
        seq.append(h)
    assert torch.equal(got, torch.stack(seq))


def test_pipeline_stage_params_and_schedule():
    """Stage i's parameters are the block of position i (a Placed leaf
    laid out over "pipe" is used as it is); every stage sees each
    microbatch once, in order; one stage is the plain loop; an axis the
    mesh lacks raises."""
    mesh = Mesh.repeat("cpu", (3, 2), ("pipe", "data"))
    seen = []

    def stage(p, h):
        seen.append((int(p["id"]), int(h[0, 0])))
        return h + 100 * p["id"]
    params = {"id": torch.arange(3)[:, None]}
    x = torch.arange(4)[:, None, None] * torch.ones(4, 2, 1,
                                                    dtype=torch.int64)
    out = pipeline_apply(stage, params, x, mesh)
    assert torch.equal(out[:, 0, 0], torch.arange(4) + 300)
    for i in range(3):
        assert [m for s, m in seen if s == i] == [
            m + 100 * (i * (i - 1) // 2) for m in range(4)]
    placed = {"id": Placed.place(params["id"],
                                 NamedSharding(mesh, P("pipe")))}
    assert torch.equal(pipeline_apply(stage, placed, x, mesh), out)
    one = Mesh.repeat("cpu", (1,), ("pipe",))
    assert torch.equal(pipeline_apply(stage, {"id": torch.ones(1, 1)}, x,
                                      one), x + 100)
    with pytest.raises(ValueError, match="not an axis"):
        pipeline_apply(stage, params, x, mesh, axis="stage")


# -- placed tensors -----------------------------------------------------------


def test_placed_tensor_blocks_full_write_and_refusals():
    """A Placed tensor holds each position's block on its device (one
    tensor for positions on one device with the same indices, a replica
    on each other device), assembles and writes back exactly, and raises
    when used as one tensor."""
    devices = np.array([["cpu", "cpu"], ["meta", "meta"]], dtype=object)
    mesh = Mesh(devices, ("pod", "model"))
    x = torch.arange(48, dtype=torch.float32).reshape(4, 12)
    a = Placed.place(x, NamedSharding(mesh, P(None, "model")))
    assert a.block((0, 1)).device.type == "cpu"
    assert a.block((1, 1)).device.type == "meta"
    assert torch.equal(a.block((0, 1)), x[:, 6:])
    assert a.nbytes == 2 * x.numel() * 4          # a replica on each device
    assert a.nbytes_at((1, 0)) == x.numel() * 2
    assert torch.equal(a.full(), x) and a.full().device.type == "cpu"
    a.write(x * 2)
    assert torch.equal(a.full(), x * 2)
    b = Placed.place(x, NamedSharding(
        Mesh.repeat("cpu", (2, 2), ("pod", "model")), P(("pod", "model"))))
    assert len(b.tiles) == 4 and torch.equal(b.full(), x)
    with pytest.raises(TypeError, match="not one tensor"):
        torch.add(a, 1)
    with pytest.raises(TypeError, match="not one tensor"):
        a[0]
    with pytest.raises(TypeError, match="not one tensor"):
        np.asarray(a)
    with pytest.raises(ValueError, match="does not divide"):
        Placed.place(torch.zeros(3, 2), NamedSharding(mesh, P("model")))
    # one block is the leaf itself: full() returns it, no copy
    r = Placed.place(x, NamedSharding(Mesh.repeat("cpu", (4,), ("d",)), P()))
    assert r.full() is r.tiles[(None, None)][0]


def test_constrain_keeps_tensors_and_replaces_placed():
    """`aconstrain` / `constrain` return a tensor as it is (no value
    changes), and re-place a Placed one by the legalized spec on the
    active mesh; no mesh, or an all-None spec, keeps it."""
    mesh = Mesh.repeat("cpu", (2, 2), ("data", "model"))
    rules = rules_for_mesh(mesh)
    x = torch.randn(4, 3, 6)
    a = Placed.place(x, NamedSharding(mesh, P()))
    assert aconstrain(x, "batch", None, "tensor") is x
    assert aconstrain(a, "batch", None, "tensor") is a     # no active mesh
    with active_mesh(mesh, rules):
        assert aconstrain(x, "batch", None, "tensor") is x
        b = aconstrain(a, "batch", None, "tensor")
        assert tuple(b.sharding.spec) == ("data", None, "model")
        assert torch.equal(b.full(), x)
        c = constrain(a, rules, "batch", "tensor", None)   # 3 % 2: dropped
        assert tuple(c.sharding.spec) == ("data", None, None)
        assert constrain(a, Rules(batch=(), tensor=()), "batch", None,
                         "tensor") is a


# -- the placed steps ---------------------------------------------------------


def _tensors(tree):
    return tree_lib.tree_map(
        lambda a: a.full() if isinstance(a, Placed) else a, tree)


def _bits_equal(a, b) -> bool:
    la, lb = tree_lib.leaves(_tensors(a)), tree_lib.leaves(_tensors(b))
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(x.view(-1).view(torch.uint8)
                        if x.is_floating_point() else x,
                        y.view(-1).view(torch.uint8)
                        if y.is_floating_point() else y)
        for x, y in zip(la, lb))


PLACED_CASES = {
    "adamw-accum2": ("starcoder2-3b", {}, 2),
    "adafactor": ("starcoder2-3b", {"optimizer": "adafactor"}, 1),
    "adamw8bit": ("starcoder2-3b", {"optimizer": "adamw8bit"}, 1),
    "int8": ("starcoder2-3b", {"grad_compression": "int8"}, 1),
    "moe": ("deepseek-moe-16b", {}, 1),
    "xlstm": ("xlstm-350m", {}, 1),
}


@pytest.mark.parametrize("case", list(PLACED_CASES))
def test_placed_train_step_equals_unplaced_bit_for_bit(case):
    """starcoder2-3b smoke (and MoE, xLSTM), 3 steps on one batch: the step
    under `active_mesh` on (2, 2, 2) CPU positions, with parameters and
    state placed by `param_shardings` / `opt_shardings` and the batch by
    `input_specs`, equals the unplaced step bit for bit in every loss,
    grad norm, parameter and state leaf; the placed leaves stay placed;
    starcoder2-3b's loss falls under adamw."""
    arch, kw, accum = PLACED_CASES[case]
    cfg = load_config(arch, smoke=True)
    tc = TrainConfig(learning_rate=1e-3, **kw)
    mesh = _mesh("2x2x2")
    rules = rules_for_mesh(mesh)
    B, T = 8, 16
    shape = ShapeConfig("custom", T, B, "train", B // accum)
    rng = np.random.default_rng(3)
    batch = {k: torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (accum, B // accum, T)).astype(np.int32))
        for k in ("tokens", "labels")}
    params0 = tfm.init(torch.Generator().manual_seed(0), cfg)

    step, optimizer = S.make_train_step(cfg, tc)
    pu = tree_lib.tree_map(torch.clone, params0)
    su = optimizer.init(pu)
    mu = []
    for _ in range(3):
        pu, su, m = step(pu, su, batch)
        mu.append({k: float(v) for k, v in m.items()})

    with active_mesh(mesh, rules):
        pstep, _ = S.make_train_step(cfg, tc, rules=rules)
        aps = tfm.abstract_params(cfg)
        psh = S.param_shardings(cfg, mesh, rules)
        pp = place(tree_lib.tree_map(torch.clone, params0), psh)
        sp = place(optimizer.init(params0), S.opt_shardings(
            optimizer.init(aps), aps, psh, mesh, rules))
        specs = S.input_specs(cfg, shape, mesh, rules)
        bp = place(batch, {k: v.sharding for k, v in specs.items()})
        mp = []
        for _ in range(3):
            pp, sp, m = pstep(pp, sp, bp)
            mp.append({k: float(v) for k, v in m.items()})
    assert mp == mu
    assert all(isinstance(x, Placed) for x in tree_lib.leaves(pp))
    assert _bits_equal(pp, pu) and _bits_equal(sp, su)
    assert all(m["applied"] == 1.0 for m in mu)
    if case == "adamw-accum2":
        assert mu[-1]["loss"] < mu[0]["loss"], mu


def test_gradients_are_row_major():
    """`_grads` returns every gradient row-major: autograd gives the tied
    embedding's transposed, and the norm's sum over it ran in another
    order than over the placed step's assembled copy (found while
    porting the placed step; the step's norm now sums row-major values
    on both sides)."""
    cfg = load_config("starcoder2-3b", smoke=True)
    params = tfm.init(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(0)
    mb = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8))
                              .astype(np.int32)) for k in ("tokens",
                                                           "labels")}
    _, grads = S._grads(params, cfg, mb)
    names = tree_lib.flatten_with_names(params)[0]
    assert all(g.is_contiguous() for g in grads), [
        n for n, g in zip(names, grads) if not g.is_contiguous()]


def test_placed_hat_meta_step_equals_unplaced_bit_for_bit():
    """The HAT trainer's pretrain and meta steps on an episode placed over
    a (4,) "data" mesh of CPU positions equal the unplaced steps bit for
    bit (loss, every parameter and state leaf)."""
    from repro_torch.configs.omniglot_conv4 import get_smoke_config
    from repro_torch.data.fsl import EpisodeSampler, OmniglotLike
    from repro_torch.models.controller import apply_conv4
    from repro_torch.optim import adamw
    fsl = get_smoke_config()
    ds = OmniglotLike(n_classes=8, image_size=fsl.image_size, seed=0)
    ep = EpisodeSampler(ds, np.arange(8), n_way=4, k_shot=2, n_query=2,
                        seed=1).episode(0)
    arrays = {"support_images": ep.support_images,
              "support_labels": ep.support_labels,
              "query_images": ep.query_images,
              "query_labels": ep.query_labels}
    hat_cfg = t_train.hat_config(fsl)
    outs = []
    for mesh in (None, Mesh.repeat("cpu", (4,), ("data",))):
        opt = adamw(1e-3)
        pre, meta, place_fn = S.make_hat_train_steps(
            apply_conv4, hat_cfg, opt, n_way=4, device="cpu", mesh=mesh)
        params = {"backbone": t_train.init_params(
            fsl, 8, 0, 8, "cpu")["backbone"]}
        state = opt.init(params)
        placed = place_fn(arrays)
        if mesh is not None:
            assert all(isinstance(v, Placed) for v in placed.values())
        params, state, loss = meta(params, state, placed,
                                   t_train.step_key(0, 0))
        outs.append((float(loss), params, state))
    assert outs[0][0] == outs[1][0] and math.isfinite(outs[0][0])
    assert _bits_equal(outs[0][1], outs[1][1])
    assert _bits_equal(outs[0][2], outs[1][2])


def test_train_model_parallel_2_equals_1_in_both_packages(
        tmp_path, restore_process_state):
    """On one device the host mesh of `model_parallel=2` is (1, 1): the
    run equals `model_parallel=1` bit for bit, in the port and in the
    reference (whose `train` on one CPU device runs too)."""
    assert make_host_mesh(2, "cpu").devices.shape == (1, 1)
    runs = {}
    for mp in (1, 2):
        runs[mp] = t_train.train("starcoder2-3b", True, 2, 2, 16,
                                 str(tmp_path / f"t{mp}"),
                                 model_parallel=mp, device="cpu")
    assert runs[1] == runs[2] and len(runs[1]) == 2
    assert all(math.isfinite(x) for x in runs[1])
    jruns = {mp: j_train.train("starcoder2-3b", True, 2, 2, 16,
                               str(tmp_path / f"j{mp}"), model_parallel=mp)
             for mp in (1, 2)}
    assert jruns[1] == jruns[2] and len(jruns[1]) == 2


@pytest.fixture
def restore_process_state(monkeypatch):
    """Put back what the trainers set for the process: torch's
    determinism settings and the SIGTERM / SIGINT handlers."""
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM,
                                                 signal.SIGINT)}
    yield
    torch.use_deterministic_algorithms(saved[0])
    torch.backends.cudnn.deterministic = saved[1]
    torch.backends.cudnn.benchmark = saved[2]
    for s, h in handlers.items():
        signal.signal(s, h)
