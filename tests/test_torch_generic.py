"""oceananigans_torch's generic momentum entry point
(``ops/cuda_generic.fused_momentum_tendency``) against the JAX package, on
the CPU in float64.

On the CPU the wrapper runs its plain version, so these tests hold the
kernel's contract (the zero x-halo rows, the ``ValueError`` cases, the
gate) and its plain version to the JAX package: to the JAX Pallas kernel
in interpret mode at the JAX test's WENO-5 case
(``tests/test_ensemble_and_pallas.py``), and to the JAX package's
``div_vu``/``div_vv``/``div_vw`` for every other scheme. The CUDA kernel
itself is held to the plain version on the card
(``tests/test_torch_generic_gpu.py``, ``chip_smoke.py``). Tolerance: 1e-12
of the largest reference value.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oceananigans_torch as ot
import oceananigans_tpu as oj
from oceananigans_torch.ops import cuda_generic as cg
from oceananigans_tpu import advection as j_adv
from oceananigans_tpu.ops.pallas_generic import (
    fused_momentum_tendency as j_fused,
)

RTOL = 1e-12
F64 = torch.float64
BPP = dict(topology=(oj.Bounded, oj.Periodic, oj.Periodic))


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


def grids(**kw):
    return (oj.RectilinearGrid(dtype="float64", **kw),
            ot.RectilinearGrid(dtype=F64, **kw))


def random_fields(shape, seed=2):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape) for _ in range(3)]


def assert_close(got, ref):
    ref = np.asarray(ref)
    scale = np.abs(ref).max()
    assert scale > 0
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=RTOL * scale)


def test_weno5_matches_jax_pallas_interpret():
    """The JAX test's case: WENO-5 at (8, 16, 128), x halo 3, against the
    JAX Pallas kernel in interpret mode, on every point (the x-halo rows
    of both are zero)."""
    jg, tg = grids(size=(8, 16, 128), extent=(0.5, 1.0, 2.0),
                   halo=(3, 0, 0), **BPP)
    arrays = random_fields((8 + 6, 16, 128))
    ref = j_fused(jg, oj.WENO(5), *map(jnp.asarray, arrays), interpret=True)
    n = cg.fused_momentum_tendency.launches
    got = cg.fused_momentum_tendency(tg, ot.WENO(5),
                                     *map(torch.tensor, arrays), tile_x=4)
    assert cg.fused_momentum_tendency.launches == n   # none on the CPU
    for g, r in zip(got, ref):
        assert_close(g, r)
        assert float(g[:3].abs().max()) == float(g[-3:].abs().max()) == 0.0


SCHEMES = ([("Centered", k) for k in range(2, 13, 2)]
           + [("UpwindBiased", k) for k in range(1, 12, 2)]
           + [("WENO", k) for k in (3, 7, 9, 11)]
           + [(("WENO", 5), ("Centered", 2), ("UpwindBiased", 3)),
              (("UpwindBiased", 11), ("WENO", 9), ("Centered", 12))])


def make(pkg, spec):
    if isinstance(spec[0], tuple):
        return pkg.FluxFormAdvection(*(getattr(pkg, k)(o) for k, o in spec))
    return getattr(pkg, spec[0])(spec[1])


@pytest.mark.parametrize("spec", SCHEMES, ids=str)
def test_schemes_match_jax_divergences(spec):
    """Every scheme against −div_vu/−div_vv/−div_vw of the JAX package on
    the interior x-rows, and zero x-halo rows, with haloed y and z."""
    jg, tg = grids(size=(9, 11, 14), extent=(1.0, 2.0, 0.5), halo=(6, 6, 6),
                   topology=(oj.Periodic, oj.Bounded, oj.Bounded))
    arrays = random_fields(tg.shape, seed=4)
    arrays[0][:, :, ::3] = 0.0     # exact zeros of the advecting velocity
    js, ts = make(oj, spec), make(ot, spec)
    assert cg.generic_available(tg, ts)
    got = cg.fused_momentum_tendency(tg, ts, *map(torch.tensor, arrays))
    ja = list(map(jnp.asarray, arrays))
    H = tg.H[0]
    S = slice(H, tg.shape[0] - H)
    for g, div in zip(got, (j_adv.div_vu, j_adv.div_vv, j_adv.div_vw)):
        assert_close(g[S], -div(jg, js, *ja)[S])
        assert float(g[:H].abs().max()) == 0.0
        assert float(g[S.stop:].abs().max()) == 0.0


def test_flat_axis_plain_version_matches_jax_pallas():
    """The plain version takes Δ = 1 on an axis of one cell, as the JAX
    wrapper's metric proxy does; the entry point refuses that layout."""
    jg, tg = grids(size=(8, 16), x=(0.0, 2.0), y=(0.0, 1.0), halo=(3, 0, 0),
                   topology=(oj.Bounded, oj.Periodic, oj.Flat))
    arrays = random_fields(tg.shape, seed=6)
    ref = j_fused(jg, oj.WENO(5), *map(jnp.asarray, arrays), interpret=True)
    got = cg.fused_momentum_tendency_plain(tg, ot.WENO(5),
                                           *map(torch.tensor, arrays))
    for g, r in zip(got, ref):
        assert_close(g, r)
    assert not cg.generic_available(tg, ot.WENO(5))
    with pytest.raises(ValueError):
        cg.fused_momentum_tendency(tg, ot.WENO(5),
                                   *map(torch.tensor, arrays))


def test_value_errors():
    """The JAX wrapper's ValueErrors, raised by both packages, and the
    gate's refusals."""
    jg, tg = grids(size=(8, 8, 8), extent=(1.0, 1.0, 1.0), halo=(2, 0, 0),
                   **BPP)
    arrays = random_fields(tg.shape)
    with pytest.raises(ValueError):
        j_fused(jg, oj.WENO(5), *map(jnp.asarray, arrays), interpret=True)
    for sch in (ot.WENO(5), ot.Centered(6), ot.UpwindBiased(5),
                ot.FluxFormAdvection(ot.Centered(2), ot.WENO(5))):
        with pytest.raises(ValueError, match="axis-0 halo"):
            cg.fused_momentum_tendency(tg, sch, *map(torch.tensor, arrays))
        with pytest.raises(ValueError, match="axis-0 halo"):
            cg.fused_momentum_tendency_plain(tg, sch,
                                             *map(torch.tensor, arrays))
    # x fits WENO(3), but y's halo of 1 is short of WENO(5)'s reach
    part = ot.RectilinearGrid(size=(8, 8, 8), extent=(1.0, 1.0, 1.0),
                              topology=(ot.Bounded, ot.Bounded, ot.Periodic),
                              halo=(3, 1, 0), dtype=F64)
    ffa = ot.FluxFormAdvection(ot.WENO(3), ot.WENO(5), ot.Centered(2))
    assert not cg.generic_available(part, ffa)
    assert cg.generic_available(part, ot.FluxFormAdvection(
        ot.WENO(5), ot.UpwindBiased(1), ot.Centered(2)))
    with pytest.raises(ValueError, match="generic_available"):
        cg.fused_momentum_tendency(part, ffa, *(torch.zeros(part.shape,
                                                            dtype=F64)
                                                for _ in range(3)))
    # operands of the wrong shape
    good = ot.RectilinearGrid(size=(8, 8, 8), extent=(1.0, 1.0, 1.0),
                              halo=(3, 0, 0), dtype=F64,
                              topology=(ot.Bounded, ot.Periodic, ot.Periodic))
    with pytest.raises(ValueError):
        cg.fused_momentum_tendency(good, ot.WENO(5),
                                   *map(torch.tensor, arrays))


def test_scheme_codes():
    assert cg.scheme_code(ot.Centered(12)) == 12
    assert cg.scheme_code(ot.UpwindBiased(1)) == 17
    assert cg.scheme_code(ot.WENO(11)) == 43
    assert cg.scheme_code(ot.FluxFormAdvection(ot.WENO(5))) is None
    assert cg.axis_schemes(ot.FluxFormAdvection(
        ot.WENO(5), ot.Centered(2))) == (ot.WENO(5), ot.Centered(2),
                                         ot.WENO(5))
