"""The port's cost model (`repro_torch.core.costmodel`), `Encoding.decode`
and `svss_pair_mismatch` against the JAX package, on the CPU.

The cost model's values are exact in both packages (integers, and float
divisions of integers), so they are compared with ==; decode and the
pair mismatch are integer functions and are compared bit for bit,
dtypes included.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import costmodel as j_cost
from repro.core import encodings as j_enc
from repro_torch.core import costmodel as t_cost
from repro_torch.core import encodings as t_enc

torch.set_num_threads(1)

# (name, cl): the paper's MTMC code lengths (Omniglot 32, CUB 25) and the
# evaluation matrix's B4E / SRE, plus B4WE
ENCODINGS = [("mtmc", 32), ("mtmc", 25), ("mtmc", 8), ("b4e", 3),
             ("b4e", 2), ("sre", 4), ("b4we", 2), ("b4we", 3)]
DTYPES = {"int32": (jnp.int32, torch.int32), "int8": (jnp.int8, torch.int8),
          "float32": (jnp.float32, torch.float32)}


def _pair(name, cl):
    return j_enc.make_encoding(name, cl), t_enc.make_encoding(name, cl)


@pytest.mark.parametrize("name,cl", ENCODINGS)
def test_cost_model_equals_the_reference(name, cl):
    """Every function at d = 48 (Omniglot) and 480 (CUB), SVSS and AVSS,
    a few store sizes and string lengths: the same numbers, exactly."""
    je, te = _pair(name, cl)
    assert t_cost.BLOCK_SEARCH_RATE_HZ == j_cost.BLOCK_SEARCH_RATE_HZ
    assert t_cost.E_STRING_SEARCH == j_cost.E_STRING_SEARCH
    for d, mode, sl in itertools.product((48, 480, 50), ("svss", "avss"),
                                         (24, 16)):
        assert t_cost.iterations(d, te, mode, sl) \
            == j_cost.iterations(d, je, mode, sl)
        assert t_cost.throughput_searches_per_s(d, te, mode, sl) \
            == j_cost.throughput_searches_per_s(d, je, mode, sl)
        for n in (1, 200, 2000, 65536):
            assert t_cost.strings_used(d, te, n, sl) \
                == j_cost.strings_used(d, je, n, sl)
            assert t_cost.energy_per_query(d, te, mode, n, sl) \
                == j_cost.energy_per_query(d, je, mode, n, sl)
            for block in (131072, 4096):
                assert t_cost.blocks_required(d, te, n, sl, block) \
                    == j_cost.blocks_required(d, je, n, sl, block)


def test_cost_model_gives_the_papers_table_2():
    """The paper's iteration and throughput figures (Table 2): Omniglot
    SVSS 64 -> AVSS 2 (32x), CUB SVSS 500 -> AVSS 20 (25x)."""
    for d, cl, svss, avss in ((48, 32, 64, 2), (480, 25, 500, 20)):
        enc = t_enc.make_encoding("mtmc", cl)
        assert t_cost.iterations(d, enc, "svss") == svss
        assert t_cost.iterations(d, enc, "avss") == avss
        assert t_cost.throughput_searches_per_s(d, enc, "avss") \
            == 20_000.0 / avss
    assert t_cost.strings_used(48, t_enc.make_encoding("mtmc", 32), 2000) \
        == 128_000


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name,cl", ENCODINGS)
def test_decode_inverts_encode_and_equals_the_reference(name, cl, dtype):
    """decode(encode(v)) == v over every level, in the reference's dtype;
    on the same codes (clean and perturbed by one word step) the port's
    decode equals JAX's bit for bit."""
    je, te = _pair(name, cl)
    jd, td = DTYPES[dtype]
    v = np.arange(te.levels)
    codes = np.asarray(j_enc.make_encoding(name, cl).encode(jnp.asarray(v)))
    rng = np.random.default_rng(cl)
    noisy = np.clip(codes + rng.integers(-1, 2, size=codes.shape), 0, 3)
    for c in (codes, noisy):
        want = je.decode(jnp.asarray(c, dtype=jd))
        got = te.decode(torch.as_tensor(np.array(c)).to(td))
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = te.decode(te.encode(torch.as_tensor(v).to(td)))
    np.testing.assert_array_equal(back.numpy(), v)


@pytest.mark.parametrize("name,cl", ENCODINGS)
def test_svss_pair_mismatch_equals_the_reference(name, cl):
    je, te = _pair(name, cl)
    rng = np.random.default_rng(7 + cl)
    a = rng.integers(0, te.levels, size=(5, 9))
    b = rng.integers(0, te.levels, size=(5, 9))
    want = jax.jit(lambda x, y: j_enc.svss_pair_mismatch(je, x, y))(
        jnp.asarray(a, jnp.int32), jnp.asarray(b, jnp.int32))
    got = t_enc.svss_pair_mismatch(te, torch.as_tensor(a, dtype=torch.int32),
                                   torch.as_tensor(b, dtype=torch.int32))
    assert got.dtype == torch.int32 and got.shape == (5, 9, te.length)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
