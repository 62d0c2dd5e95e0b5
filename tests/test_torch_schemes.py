"""oceananigans_torch's Centered(2–12), UpwindBiased(1–11), WENO(3–11) and
FluxFormAdvection against the JAX package, on the CPU in float64.

Each test hands both packages the same inputs, made with numpy from a
seed: the flux divergences ``div_Uc``/``div_vu``/``div_vv``/``div_vw`` for
every order of every scheme, ``adapt_advection_order``, and a few steps of
the nonhydrostatic, shallow-water and hydrostatic models with the new
schemes. Tolerance: 1e-12 of the largest reference value (both packages
evaluate the same whole-array formulas).

Also here: the kernels of the earlier slices stay off for the new schemes
(their gates are type- and order-exact), and the coefficient header
``csrc/linear_tables.h`` is held literal by literal to the JAX package's
tables.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oceananigans_torch as ot
import oceananigans_tpu as oj
from oceananigans_torch import advection as t_adv
from oceananigans_torch.interop import (
    FIELDS, SW_FIELDS, state_from_numpy, state_to_numpy,
)
from oceananigans_tpu import advection as j_adv
from oceananigans_tpu.boundary_conditions import (
    fill_halo_regions as j_fill, regularize_field_boundary_conditions,
)
from oceananigans_tpu.models import hydrostatic as j_hyd
from oceananigans_tpu.ops.reconstruction_coefficients import (
    face_reconstruction_coefficients as j_face_coefficients,
)

RTOL = 1e-12
F64 = torch.float64
HEADER = (Path(__file__).resolve().parent.parent / "oceananigans_torch"
          / "csrc" / "linear_tables.h")
#: (kind, order) of every scheme the port has
SCHEMES = ([("Centered", k) for k in range(2, 13, 2)]
           + [("UpwindBiased", k) for k in range(1, 12, 2)]
           + [("WENO", k) for k in range(3, 12, 2)])
LOCS = {"u": oj.LOC_U, "v": oj.LOC_V, "w": oj.LOC_W, "c": oj.LOC_C}


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


def scheme(pkg, kind, order):
    return getattr(pkg, kind)(order)


def setup(size=(12, 10, 8), halo=(6, 6, 6),
          topology=(oj.Bounded, oj.Periodic, oj.Bounded), seed=5):
    """Both packages' grids and the same halo-filled random u, v, w, c,
    with u and v exactly zero on some rows (advecting velocities of both
    signs and exact zeros)."""
    kw = dict(size=size, extent=(1.0, 2.0, 0.5), topology=topology,
              halo=halo)
    jg = oj.RectilinearGrid(dtype="float64", **kw)
    tg = ot.RectilinearGrid(dtype=F64, **kw)
    rng = np.random.default_rng(seed)
    j, t = {}, {}
    for name, loc in LOCS.items():
        a = rng.standard_normal(tg.shape)
        if name == "u":
            a[:, :, ::3] = 0.0
        if name == "v":
            a[::2] = 0.0
        bcs = regularize_field_boundary_conditions(None, jg, loc)
        j[name] = j_fill(jnp.asarray(a), jg, bcs, loc)
        t[name] = ot.fill_halo_regions(torch.tensor(a), tg, loc=loc)
    return jg, tg, j, t


def assert_close(got, ref, S, rtol=RTOL):
    got = got.detach().numpy()[S]
    ref = np.asarray(ref)[S]
    scale = np.abs(ref).max()
    assert scale > 0
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * scale)


def assert_divergences(js, ts, jg, tg, j, t):
    S = tg.interior_slices
    for name in ("div_vu", "div_vv", "div_vw"):
        assert_close(getattr(t_adv, name)(tg, ts, t["u"], t["v"], t["w"]),
                     getattr(j_adv, name)(jg, js, j["u"], j["v"], j["w"]),
                     S)
    assert_close(t_adv.div_Uc(tg, ts, t["u"], t["v"], t["w"], t["c"]),
                 j_adv.div_Uc(jg, js, j["u"], j["v"], j["w"], j["c"]), S)


# ---------------------------------------------------------------------------
# The flux divergences
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fields():
    return setup()


@pytest.mark.parametrize("kind,order", SCHEMES)
def test_divergences_match_jax(kind, order, fields):
    jg, tg, j, t = fields
    js, ts = scheme(oj, kind, order), scheme(ot, kind, order)
    assert ts.required_halo == js.required_halo
    assert_divergences(js, ts, jg, tg, j, t)


FLUX_FORMS = [(("WENO", 5), ("Centered", 2), ("UpwindBiased", 3)),
              (("UpwindBiased", 11), ("WENO", 9), ("Centered", 12)),
              (("Centered", 4), ("UpwindBiased", 1), ("WENO", 3))]


@pytest.mark.parametrize("axes", FLUX_FORMS)
def test_flux_form_advection_matches_jax(axes, fields):
    jg, tg, j, t = fields
    js = oj.FluxFormAdvection(*(scheme(oj, *a) for a in axes))
    ts = ot.FluxFormAdvection(*(scheme(ot, *a) for a in axes))
    assert ts.required_halo == js.required_halo
    assert repr(ts) == repr(js)
    for axis in range(3):
        assert t_adv._scheme_for(ts, axis) == scheme(ot, *axes[axis])
    assert_divergences(js, ts, jg, tg, j, t)


@pytest.mark.parametrize("size", [(1, 2, 3), (2, 4, 40), (8, 8, 8)])
@pytest.mark.parametrize("kind,order", [("Centered", 12), ("WENO", 9),
                                        ("UpwindBiased", 7)])
def test_adapt_advection_order_matches_jax(kind, order, size):
    kw = dict(size=size, extent=(1.0, 1.0, 1.0), halo=1,
              topology=(oj.Periodic, oj.Periodic, oj.Bounded))
    jg = oj.RectilinearGrid(dtype="float64", **kw)
    tg = ot.RectilinearGrid(dtype=F64, **kw)
    ja = j_adv.adapt_advection_order(scheme(oj, kind, order), jg)
    ta = ot.adapt_advection_order(scheme(ot, kind, order), tg)
    assert repr(ta) == repr(ja)
    assert ta.required_halo == ja.required_halo
    assert type(ta).__name__ == type(ja).__name__
    assert ot.adapt_advection_order(None, tg) is None


def test_scheme_arguments():
    for make in (lambda: ot.Centered(3), lambda: ot.Centered(14),
                 lambda: ot.UpwindBiased(2), lambda: ot.UpwindBiased(13)):
        with pytest.raises(ValueError):
            make()
    assert ot.UpwindBiased(5) == ot.UpwindBiased(5)
    assert ot.UpwindBiased(5) != ot.Centered(4)
    assert len({ot.Centered(4), ot.Centered(4), ot.UpwindBiased(3)}) == 2


# ---------------------------------------------------------------------------
# The models with the new schemes
# ---------------------------------------------------------------------------

def _jax_state_arrays(s, fields):
    out = {name: np.asarray(getattr(s, name)) for name in fields}
    for group in ("tracers", "Gtracers"):
        for n, a in getattr(s, group).items():
            out[f"{group}/{n}"] = np.asarray(a)
    out.update(time=np.asarray(s.clock.time),
               iteration=int(s.clock.iteration),
               last_dt=np.asarray(s.clock.last_dt))
    return out


def _assert_fields(tg, got, ref, names):
    ii = tg.interior_slices
    for name in names:
        a, b = np.asarray(got[name])[ii], np.asarray(ref[name])[ii]
        scale = max(np.abs(b).max(), 1e-300)
        np.testing.assert_allclose(a, b, rtol=0, atol=RTOL * scale,
                                   err_msg=name)


@pytest.mark.parametrize("kind,order,timestepper", [
    ("Centered", 4, "RungeKutta3"),
    ("UpwindBiased", 5, "QuasiAdamsBashforth2")])
def test_nonhydrostatic_model_matches_jax(kind, order, timestepper):
    from oceananigans_tpu.models import NonhydrostaticModel as JModel
    kw = dict(size=(8, 6, 10), extent=(1.0, 1.0, 1.0), halo=3,
              topology=(oj.Periodic, oj.Periodic, oj.Bounded))
    jg = oj.RectilinearGrid(dtype="float64", **kw)
    tg = ot.RectilinearGrid(dtype=F64, **kw)
    jm = JModel(grid=jg, advection=scheme(oj, kind, order), tracers=("c",),
                timestepper=timestepper)
    tm = ot.NonhydrostaticModel(grid=tg, advection=scheme(ot, kind, order),
                                tracers=("c",), timestepper=timestepper,
                                fused_kernels=True)
    assert tm.fused_kernels is False
    rng = np.random.default_rng(11)
    init = {n: rng.standard_normal(kw["size"]) for n in ("u", "v", "w", "c")}
    js = jm.initial_state(**init)
    ts = state_from_numpy(tm, _jax_state_arrays(js, FIELDS))
    for _ in range(3):
        js = jm.step(js, 1e-3)
        ts = tm.step(ts, 1e-3)
    _assert_fields(tg, state_to_numpy(ts), _jax_state_arrays(js, FIELDS),
                   ("u", "v", "w", "tracers/c"))


def test_shallow_water_upwind_matches_jax():
    from oceananigans_tpu.models.shallow_water import (
        ShallowWaterModel as JModel,
    )
    kw = dict(size=(16, 12), x=(0.0, 10.0), y=(0.0, 8.0), halo=3,
              topology=(oj.Periodic, oj.Periodic, oj.Flat))
    jg = oj.RectilinearGrid(dtype="float64", **kw)
    tg = ot.RectilinearGrid(dtype=F64, **kw)
    jm = JModel(grid=jg, momentum_advection=oj.UpwindBiased(3),
                tracers=("c",), tracer_advection=oj.UpwindBiased(3))
    tm = ot.ShallowWaterModel(grid=tg, momentum_advection=ot.UpwindBiased(3),
                              tracers=("c",),
                              tracer_advection=ot.UpwindBiased(3),
                              fused_kernels=True)
    rng = np.random.default_rng(7)
    shape = (16, 12, 1)
    js = jm.initial_state(h=1.0 + 0.01 * rng.standard_normal(shape),
                          uh=0.1 * rng.standard_normal(shape),
                          vh=0.1 * rng.standard_normal(shape),
                          c=rng.standard_normal(shape))
    ts = state_from_numpy(tm, _jax_state_arrays(js, SW_FIELDS))
    for _ in range(3):
        js = jm.step(js, 2e-3)
        ts = tm.step(ts, 2e-3)
    _assert_fields(tg, state_to_numpy(ts), _jax_state_arrays(js, SW_FIELDS),
                   ("uh", "vh", "h", "tracers/c"))


def test_hydrostatic_upwind_vorticity_matches_jax():
    from oceananigans_torch.interop import HYDROSTATIC_FIELDS
    kw = dict(size=(10, 8, 4), extent=(1.0, 1.0, 1.0), halo=3,
              topology=(oj.Periodic, oj.Bounded, oj.Bounded))
    jg = oj.RectilinearGrid(dtype="float64", **kw)
    tg = ot.RectilinearGrid(dtype=F64, **kw)
    jm = j_hyd.HydrostaticFreeSurfaceModel(
        grid=jg, tracers=("T",), tracer_advection=oj.UpwindBiased(3),
        momentum_advection=j_hyd.VectorInvariant(
            vorticity_scheme=oj.UpwindBiased(3),
            vertical_scheme=oj.UpwindBiased(3)),
        free_surface=j_hyd.ExplicitFreeSurface(gravitational_acceleration=1.0))
    tm = ot.HydrostaticFreeSurfaceModel(
        grid=tg, tracers=("T",), tracer_advection=ot.UpwindBiased(3),
        momentum_advection=ot.VectorInvariant(
            vorticity_scheme=ot.UpwindBiased(3),
            vertical_scheme=ot.UpwindBiased(3)),
        free_surface=ot.ExplicitFreeSurface(gravitational_acceleration=1.0),
        fused_kernels=True)
    assert not (tm.fused_kernels or tm.fused_tracer)
    js = jm.initial_state(
        u=lambda x, y, z: 0.1 * jnp.sin(2 * np.pi * x) * jnp.cos(np.pi * y),
        v=lambda x, y, z: 0.05 * jnp.cos(2 * np.pi * x),
        T=lambda x, y, z: 20.0 + 2.0 * z + jnp.sin(2 * np.pi * x),
        eta=lambda x, y: 1e-3 * jnp.cos(2 * np.pi * x) * jnp.cos(np.pi * y))
    ts = state_from_numpy(tm, _jax_state_arrays(js, HYDROSTATIC_FIELDS))
    for _ in range(3):
        js = jm.step(js, 5e-3)
        ts = tm.step(ts, 5e-3)
    _assert_fields(tg, state_to_numpy(ts),
                   _jax_state_arrays(js, HYDROSTATIC_FIELDS),
                   ("u", "v", "tracers/T"))


# ---------------------------------------------------------------------------
# The earlier kernels stay off for the new schemes
# ---------------------------------------------------------------------------

NEW_SCHEMES = [ot.Centered(4), ot.UpwindBiased(5), ot.UpwindBiased(3),
               ot.FluxFormAdvection(ot.Centered(2)),
               ot.FluxFormAdvection(ot.WENO(5)),
               ot.FluxFormAdvection(ot.WENO(7), ot.WENO(7), ot.WENO(7))]


@pytest.mark.parametrize("sch", NEW_SCHEMES, ids=repr)
def test_new_schemes_enter_no_earlier_kernel(sch):
    from oceananigans_torch.ops import cuda_kernels as ck
    from oceananigans_torch.ops import cuda_sw as csw
    from oceananigans_torch.ops import cuda_tracer as ctr
    from oceananigans_torch.ops import cuda_vi as cvi
    from oceananigans_torch.ops import cuda_weno as cw
    g = ot.RectilinearGrid(size=(16, 16, 16), extent=(1.0, 1.0, 1.0),
                           topology=(ot.Bounded, ot.Periodic, ot.Periodic),
                           halo=(6, 0, 0), dtype=F64)
    assert not ck.fused_available(g, sch)
    assert not cw.weno5_available(g, sch)
    assert not ctr.tracer_fusion_available(g, sch)
    vi = ot.VectorInvariant(vorticity_scheme=sch, vertical_scheme=sch)
    assert not cvi.vi_available(g, vi)
    model = ot.NonhydrostaticModel(grid=g, advection=sch, fused_kernels=True,
                                   timestepper="QuasiAdamsBashforth2")
    assert model.fused_kernels is False
    assert not (model.fused_ab2 or model.fused_ab2_weno
                or model.fused_ab2_science or model.fused_ab2_weno_science)
    hg = ot.RectilinearGrid(size=(12, 10, 6), extent=(1.0, 1.0, 1.0),
                            topology=(ot.Periodic, ot.Bounded, ot.Bounded),
                            halo=6, dtype=F64)
    hm = ot.HydrostaticFreeSurfaceModel(grid=hg, momentum_advection=vi,
                                        tracer_advection=sch, tracers=("T",),
                                        fused_kernels=True)
    assert not (hm.fused_kernels or hm.fused_tracer)
    sg = ot.RectilinearGrid(size=(16, 16), x=(0.0, 1.0), y=(0.0, 1.0),
                            topology=(ot.Periodic, ot.Periodic, ot.Flat),
                            halo=6, dtype=F64)
    sm = ot.ShallowWaterModel(grid=sg, momentum_advection=sch,
                              fused_kernels=True)
    assert not csw.sw_fused_available(sg, sm)
    assert not sm.fused_rk3


# ---------------------------------------------------------------------------
# The coefficient header
# ---------------------------------------------------------------------------

def _parse_header():
    """{(table, order): (B, [coefficients])} from linear_tables.h."""
    text = HEADER.read_text()
    number = r"-?\d+(?:\.\d+)?(?:[eE][-+]?\d+)?"
    out = {}
    for m in re.finditer(r"struct (CenteredTable|UpwindTable)<(\d+)> \{"
                         r"(.*?)\n\};", text, re.S):
        body = m.group(3)
        B = int(re.search(r"int B = (\d+);", body).group(1))
        taps = int(re.search(r"int taps = (\d+);", body).group(1))
        c = re.search(r"constexpr double c\[\d+\] = (\{.*?\});", body, re.S)
        vals = [float(x) for x in re.findall(number, c.group(1))]
        assert len(vals) == taps
        out[(m.group(1), int(m.group(2)))] = (B, vals)
    return out


def test_linear_tables_header_matches_jax():
    tables = _parse_header()
    expected = ([("CenteredTable", k) for k in range(2, 13, 2)]
                + [("UpwindTable", k) for k in range(1, 12, 2)])
    assert sorted(tables) == sorted(expected)
    for (name, order), (B, vals) in tables.items():
        bias = "centered" if name == "CenteredTable" else "left"
        ref = j_face_coefficients(order, bias)
        offsets = sorted(ref)
        assert offsets[0] == -B and offsets == list(range(-B, -B + len(vals)))
        np.testing.assert_array_equal(vals, [ref[n] for n in offsets])
        port = t_adv.face_reconstruction_coefficients(order, bias)
        assert port == ref
