"""oceananigans_torch's immersed and stretched paths on the card against
the CPU.

These tests need a CUDA device and skip without one. They import nothing
of JAX, so they also run on a machine without it:

    python -m pytest --noconftest tests/test_torch_immersed_gpu.py -m gpu

The seamount model of ``chip_smoke.py`` phase 18 at (16, 16, 8) and the
``hydro_vi_bathy`` ocean of phase 19 at a (24, 16, 8) sector, in float64,
after 3 steps on the card within 1e-12 of each field's largest value on
the CPU where the conjugate gradient takes the same iteration counts on
both (it does here; the counts are asserted equal); the CG whose flag the
host reads every 4 iterations gives, on the card, the solution of a read
every iteration bit for bit; and no port kernel launches on an immersed
or a stretched grid, whatever ``fused_kernels`` asks.
"""

import importlib

import pytest
import torch

import oceananigans_torch as ot
from oceananigans_torch.immersed import ImmersedPoissonSolver
from oceananigans_torch.ops import (
    cuda_generic, cuda_kernels, cuda_poisson, cuda_sw, cuda_tracer, cuda_vi,
    cuda_weno,
)
from oceananigans_torch.profile_step import (
    HYDRO_DT, SEAMOUNT_DT, hydro_latlon_initial_state, hydro_latlon_model,
    latlon_continents, seamount_initial_state, seamount_model,
)

RTOL = 1e-12
#: the conjugate-gradient module (its name is shadowed by the function in
#: ``oceananigans_torch.solvers``)
cgmod = importlib.import_module(
    "oceananigans_torch.solvers.conjugate_gradient")


def wrappers():
    """Every kernel wrapper of the port that counts its launches."""
    out = []
    for mod in (cuda_generic, cuda_kernels, cuda_poisson, cuda_sw,
                cuda_tracer, cuda_vi, cuda_weno):
        for name in dir(mod):
            fn = getattr(mod, name)
            if callable(fn) and hasattr(fn, "launches"):
                out.append(fn)
    return out


def rel(pairs):
    diff = max(float((a.cpu() - b).abs().max()) for a, b in pairs)
    return diff / max(float(b.abs().max()) for _, b in pairs)


def needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
def test_seamount_on_card_matches_cpu():
    needs_cuda()
    runs = {}
    for device in ("cuda", "cpu"):
        m = seamount_model((16, 16, 8), torch.float64, device)
        s = seamount_initial_state(m)
        its = []
        for _ in range(3):
            s = m.step(s, SEAMOUNT_DT)
            its.append(int(m.pressure_solver.iterations))
        runs[device] = (m.grid, s, its)
    (gk, sk, ik), (gp, sp, ip) = runs["cuda"], runs["cpu"]
    assert ik == ip
    assert rel([(gk.interior(getattr(sk, n)), gp.interior(getattr(sp, n)))
                for n in ("u", "v", "w")]) <= RTOL
    assert rel([(gk.interior(sk.tracers["b"]),
                 gp.interior(sp.tracers["b"]))]) <= RTOL


@pytest.mark.gpu
def test_bathy_sector_on_card_matches_cpu():
    needs_cuda()
    runs = {}
    for device in ("cuda", "cpu"):
        m = hydro_latlon_model("auto", torch.float64, device,
                               size=(24, 16, 8), longitude=(-60.0, 60.0),
                               latitude=(-80.0, 80.0), halo=6,
                               bathymetry=latlon_continents)
        assert not m.fused_kernels and not m.fused_tracer
        s = hydro_latlon_initial_state(m, generic=True)
        for _ in range(3):
            s = m.step(s, HYDRO_DT)
        runs[device] = (m.grid, s)
    (gk, sk), (gp, sp) = runs["cuda"], runs["cpu"]
    for names in (("u", "v"), ("w",)):
        assert rel([(gk.interior(getattr(sk, n)),
                     gp.interior(getattr(sp, n))) for n in names]) <= RTOL
    xy = gp.interior_slices[:2]
    assert rel([(sk.eta[xy], sp.eta[xy])]) <= RTOL
    for n in ("T", "S"):
        assert rel([(gk.interior(sk.tracers[n]),
                     gp.interior(sp.tracers[n]))]) <= RTOL


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cg_flag_read_every_k_on_card(dtype, monkeypatch):
    """Reads every 1, 3 and 4 iterations: the same solution, bit for bit,
    and the same iteration count."""
    needs_cuda()
    m = seamount_model((32, 32, 16), dtype, "cuda")
    rhs = torch.randn(m.grid.N, dtype=dtype, device="cuda",
                      generator=torch.Generator("cuda").manual_seed(0))
    out = {}
    for k in (1, 3, 4):
        monkeypatch.setattr(cgmod, "CHECK_EVERY", k)
        solver = ImmersedPoissonSolver(m.grid)
        out[k] = (solver.solve(rhs), int(solver.iterations),
                  solver.host_syncs)
    for k in (3, 4):
        assert torch.equal(out[k][0], out[1][0])
        assert out[k][1] == out[1][1] > 1
        assert out[k][2] == -(-out[1][1] // k) + 1


@pytest.mark.gpu
def test_no_kernel_on_immersed_or_stretched_grids():
    needs_cuda()
    fns = wrappers()
    assert len(fns) >= 13
    for fn in fns:
        fn.launches = 0
    m = seamount_model((32, 32, 16), torch.float32, "cuda")
    s = seamount_initial_state(m)
    for _ in range(2):
        s = m.step(s, SEAMOUNT_DT)
    h = hydro_latlon_model("auto", torch.float32, "cuda", size=(36, 16, 8),
                           bathymetry=latlon_continents)
    t = h.step(hydro_latlon_initial_state(h), HYDRO_DT)
    grid = ot.RectilinearGrid(
        size=(32, 32, 24), x=(0.0, 64.0), y=(0.0, 64.0),
        z=lambda k: -32.0 * (1 - k / 24) ** 1.2, halo=(3, 3, 3),
        device="cuda")
    les = ot.NonhydrostaticModel(grid=grid, advection=ot.WENO(5),
                                 tracers=("T",), fused_kernels=True,
                                 timestepper="QuasiAdamsBashforth2")
    assert les.fused_kernels is False and not les.fused_tracer
    u = les.step(les.initial_state(T=lambda x, y, z: 20 + 0.01 * z), 1.0)
    torch.cuda.synchronize()
    assert all(fn.launches == 0 for fn in fns)
    assert all(bool(torch.isfinite(q).all())
               for q in (s.u, s.w, t.u, t.eta, u.w))
