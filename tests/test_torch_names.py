"""Every name the JAX package's modules define has its counterpart in the
port.

For each module of ``oceananigans_tpu`` but the Pallas kernels'
(``ops/pallas_*``, whose counterparts are the port's ``ops/cuda_*``), the
port's module of the same path holds every name of the JAX module's
``__all__``, every public name a package's ``__init__`` binds (modules
aside), and every public function and class the module defines. The
exclusions are :data:`EXCLUDED`, each with its reason. Also here: the
names that were added last, held against the JAX package's: the WENO(5)
indicator check and the horizontal matmul basis of the implicit free
surface.
"""

import importlib
import inspect
import pathlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oceananigans_torch as ot
import oceananigans_tpu as oj

#: JAX names the port does not define, by module, each with its reason
EXCLUDED = {
    "oceananigans_tpu.grids.base": {
        "register_grid": "registers a grid class as a JAX pytree; the "
                         "port's grids are torch modules",
    },
}


def jax_modules():
    """The JAX package's module names, the Pallas kernels' excepted, from
    its files (collection imports none of them)."""
    root = pathlib.Path(oj.__file__).parent
    names = []
    for path in sorted(root.rglob("*.py")):
        parts = path.relative_to(root.parent).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        names.append(".".join(parts))
    return [n for n in names if ".ops.pallas_" not in n]


def public_names(module):
    """What the port must define of the JAX ``module``."""
    want = set(getattr(module, "__all__", ()))
    for name, value in vars(module).items():
        if name.startswith("_"):
            continue
        if hasattr(module, "__path__"):
            if not isinstance(value, types.ModuleType):
                want.add(name)
        elif ((inspect.isfunction(value) or inspect.isclass(value))
              and value.__module__ == module.__name__):
            want.add(name)
    return want


@pytest.mark.parametrize("name", jax_modules())
def test_port_defines_every_jax_name(name):
    jax_module = importlib.import_module(name)
    port = importlib.import_module(
        name.replace(oj.__name__, ot.__name__, 1))
    excluded = EXCLUDED.get(name, {})
    missing = sorted(n for n in public_names(jax_module) - set(excluded)
                     if not hasattr(port, n))
    assert not missing, f"{port.__name__} lacks {missing}"
    for n in excluded:
        assert not hasattr(port, n), f"{n} is excluded but defined"


def test_subpackages_export_their_names():
    """The operator vocabulary from ``ops``, the transforms and the
    tridiagonal solve from ``solvers``, ``fields`` from ``models``, and the
    advection schemes' common base."""
    from oceananigans_torch.advection import (
        AdvectionScheme, BoundPreserving, Centered, FluxFormAdvection,
        UpwindBiased, WENO,
    )
    from oceananigans_torch.ops import ddx_c
    from oceananigans_torch.ops.operators import ddx_c as op
    from oceananigans_torch.solvers import (  # noqa: F401
        dct2, idct2, poisson_eigenvalues, tridiagonal_solve,
    )
    assert ddx_c is op
    for cls in (Centered, UpwindBiased, WENO, BoundPreserving):
        assert issubclass(cls, AdvectionScheme)
    assert not issubclass(FluxFormAdvection, AdvectionScheme)
    assert Centered(4) == Centered(4) != UpwindBiased(3)
    assert hash(Centered(4)) == hash(Centered(4))
    assert UpwindBiased(5).required_halo == 3
    grid = ot.RectilinearGrid(size=(4, 3, 2), extent=(1.0, 1.0, 1.0),
                              dtype=torch.float64, device="cpu")
    model = ot.HydrostaticFreeSurfaceModel(grid=grid, tracers=("T",))
    state = model.initial_state()
    fields = ot.models.fields(state)
    assert list(fields) == ["u", "v", "w", "eta", "T"]
    assert fields["eta"] is state.eta
    assert ot.fields.interior_xy(grid, state.eta).shape == (4, 3, 1)
    a = ot.grids.base.broadcastable(np.arange(5.0), 1)
    assert isinstance(a, torch.Tensor) and a.shape == (1, 5, 1)


def test_validate_k3():
    from oceananigans_torch.ops.reconstruction_coefficients import (
        validate_k3,
    )
    assert validate_k3() is True


def test_matmul_horizontal_basis_matches_jax():
    """On a (Bounded, Periodic) grid the port's basis inverts its forward
    transform, and its transform and eigenvalues equal the JAX
    package's, to 1e-12 of their largest values, in float64."""
    from oceananigans_torch.solvers.matmul_poisson import (
        MatmulHorizontalBasis,
    )
    from oceananigans_tpu.solvers.matmul_poisson import (
        MatmulHorizontalBasis as JBasis,
    )
    kw = dict(size=(6, 8, 3), extent=(2.0, 3.0, 1.0),
              topology=(oj.Bounded, oj.Periodic, oj.Bounded))
    tb = MatmulHorizontalBasis(ot.RectilinearGrid(
        dtype=torch.float64, device="cpu", **kw))
    jb = JBasis(oj.RectilinearGrid(dtype="float64", **kw))
    r = np.random.default_rng(21).standard_normal((6, 8, 1))
    got = tb.forward(torch.tensor(r))
    ref = np.asarray(jb.forward(jnp.asarray(r)))
    assert np.abs(got.numpy() - ref).max() <= 1e-12 * np.abs(ref).max()
    back = tb.inverse(got).numpy()
    assert np.abs(back - r).max() <= 1e-12 * np.abs(r).max()
    np.testing.assert_allclose(tb.lam2d.numpy(), jb.lam2d, rtol=0,
                               atol=1e-12 * np.abs(jb.lam2d).max())
