"""oceananigans_torch operators and Centered(2) advection against the JAX
package, in float64 on the CPU.

Both packages evaluate the same whole-array formulas in the same order, so
interiors agree to atol 1e-12 (the goldens' tolerance); values here are
O(10), far inside float64's 16 digits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oceananigans_torch as ot
import oceananigans_tpu as oj
from oceananigans_torch import advection as t_adv
from oceananigans_torch.ops import operators as t_ops
from oceananigans_tpu import advection as j_adv
from oceananigans_tpu.boundary_conditions import (
    fill_halo_regions as j_fill, regularize_field_boundary_conditions,
)
from oceananigans_tpu.ops import operators as j_ops

ATOL = 1e-12
F64 = torch.float64
CASES = {
    "bpp-h100": ((oj.Bounded, oj.Periodic, oj.Periodic), (1, 0, 0)),
    "bpp-h111": ((oj.Bounded, oj.Periodic, oj.Periodic), (1, 1, 1)),
    "pbb-h111": ((oj.Periodic, oj.Bounded, oj.Bounded), (1, 1, 1)),
}


@pytest.fixture(autouse=True, scope="module")
def on_cpu():
    """The port runs on the GPU by default; these tests ask for the CPU,
    with one intra-op thread (the test workers share the machine's cores,
    and these small tensors gain nothing from more)."""
    old = ot.config.device, torch.get_num_threads()
    ot.config.device = "cpu"
    torch.set_num_threads(1)
    yield
    ot.config.device = old[0]
    torch.set_num_threads(old[1])


def setup(case, seed=0):
    topology, halo = CASES[case]
    kw = dict(size=(8, 6, 10), extent=(1.0, 2.0, 0.5), topology=topology,
              halo=halo)
    jg = oj.RectilinearGrid(dtype="float64", **kw)
    tg = ot.RectilinearGrid(dtype=F64, **kw)
    rng = np.random.default_rng(seed)
    j, t = {}, {}
    for name, loc in (("u", oj.LOC_U), ("v", oj.LOC_V), ("w", oj.LOC_W),
                      ("c", oj.LOC_C)):
        a = rng.standard_normal(tg.shape)
        bcs = regularize_field_boundary_conditions(None, jg, loc)
        j[name] = j_fill(jnp.asarray(a), jg, bcs, loc)
        t[name] = ot.fill_halo_regions(torch.tensor(a, dtype=F64), tg,
                                       loc=loc)
    return jg, tg, j, t


def assert_interior(tg, got, ref):
    np.testing.assert_allclose(tg.interior(got).numpy(),
                               np.asarray(ref)[tg.interior_slices],
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_divergence_matches(case):
    jg, tg, j, t = setup(case)
    assert_interior(tg, t_ops.divergence_ccc(tg, t["u"], t["v"], t["w"]),
                    j_ops.divergence_ccc(jg, j["u"], j["v"], j["w"]))


@pytest.mark.parametrize("case", sorted(CASES))
def test_gradients_match(case):
    jg, tg, j, t = setup(case, seed=1)
    c_t, c_j = t["c"], j["c"]
    assert_interior(tg, t_ops.ddx_f(tg, c_t, ot.Center),
                    j_ops.ddx_f(jg, c_j, oj.Center))
    assert_interior(tg, t_ops.ddy_f(tg, c_t, ot.Center),
                    j_ops.ddy_f(jg, c_j, oj.Center))
    assert_interior(tg, t_ops.ddz_f(tg, c_t), j_ops.ddz_f(jg, c_j))


#: the rest of the operator vocabulary: name -> arguments from the fields
MORE_OPERATORS = {
    "ddx_c": lambda ops, g, f: ops.ddx_c(g, f["u"]),
    "ddy_c": lambda ops, g, f: ops.ddy_c(g, f["v"]),
    "ddz_c": lambda ops, g, f: ops.ddz_c(g, f["w"]),
    "div_xy_cc": lambda ops, g, f: ops.div_xy_cc(g, f["u"], f["v"]),
    "vorticity_z_ff": lambda ops, g, f: ops.vorticity_z_ff(g, f["u"],
                                                           f["v"]),
    "laplacian_ccc": lambda ops, g, f: ops.laplacian_ccc(g, f["c"]),
    "kinetic_energy_cc": lambda ops, g, f: ops.kinetic_energy_cc(
        g, f["u"], f["v"]),
    "kinetic_energy_ccc": lambda ops, g, f: ops.kinetic_energy_cc(
        g, f["u"], f["v"], f["w"]),
}


@pytest.mark.parametrize("name", sorted(MORE_OPERATORS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_more_operators_match(case, name):
    jg, tg, j, t = setup(case, seed=4)
    op = MORE_OPERATORS[name]
    assert_interior(tg, op(t_ops, tg, t), op(j_ops, jg, j))


def test_reductions_and_cfl_match():
    """``field_sum``, ``field_integral`` and the advective time scale."""
    from oceananigans_torch import fields as t_fields
    from oceananigans_tpu import fields as j_fields
    jg, tg, j, t = setup("pbb-h111", seed=5)
    for loc in (ot.LOC_C, ot.LOC_U):
        for fn in ("field_sum", "field_integral"):
            np.testing.assert_allclose(
                float(getattr(t_fields, fn)(tg, t["c"], loc)),
                float(getattr(j_fields, fn)(jg, j["c"], loc)),
                rtol=1e-12)
    np.testing.assert_allclose(
        float(t_adv.cell_advection_timescale(tg, t["u"], t["v"], t["w"])),
        float(j_adv.cell_advection_timescale(jg, j["u"], j["v"], j["w"])),
        rtol=1e-12)


@pytest.mark.parametrize("fn", ["div_vu", "div_vv", "div_vw"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_momentum_advection_matches(case, fn):
    jg, tg, j, t = setup(case, seed=2)
    got = getattr(t_adv, fn)(tg, t_adv.Centered(2), t["u"], t["v"], t["w"])
    ref = getattr(j_adv, fn)(jg, j_adv.Centered(2), j["u"], j["v"], j["w"])
    assert_interior(tg, got, ref)


@pytest.mark.parametrize("case", sorted(CASES))
def test_tracer_advection_matches(case):
    jg, tg, j, t = setup(case, seed=3)
    got = t_adv.div_Uc(tg, t_adv.Centered(2), t["u"], t["v"], t["w"],
                       t["c"])
    ref = j_adv.div_Uc(jg, j_adv.Centered(2), j["u"], j["v"], j["w"],
                       j["c"])
    assert_interior(tg, got, ref)


def test_shift_is_exact_roll():
    a = torch.arange(24, dtype=F64).reshape(2, 3, 4)
    np.testing.assert_array_equal(t_ops.shift(a, 1, 2).numpy(),
                                  np.asarray(j_ops.shift(jnp.asarray(
                                      a.numpy()), 1, 2)))
    assert t_ops.shift(a, 0, 1) is a


def test_unported_schemes_raise():
    """Every scheme is ported now and builds: the bound-preserving
    limiters (their halo the wrapped scheme's), Centered(4), UpwindBiased
    and FluxFormAdvection."""
    for make in (lambda: t_adv.WENO(5, bounds=(0.0, 1.0)),
                 lambda: t_adv.BoundPreserving(t_adv.WENO(5))):
        assert t_adv.required_halo(make()) == 3
    assert t_adv.required_halo(t_adv.Centered(2)) == 1
    assert t_adv.required_halo(t_adv.WENO(5)) == 3
    assert t_adv.required_halo(t_adv.Centered(4)) == 2
    assert t_adv.required_halo(t_adv.UpwindBiased(3)) == 2
    assert t_adv.required_halo(
        t_adv.FluxFormAdvection(t_adv.WENO(5), t_adv.Centered(2))) == 3
