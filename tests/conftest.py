"""Test config: CPU platform with 8 virtual devices for mesh/sharding tests.

Must run before jax is first used anywhere: the platform is pinned to the
CPU here unless ``JAX_PLATFORMS`` names others. Tests marked ``gpu`` take
the ``gpu_device`` fixture, which skips them unless a GPU is present; on
the card they run with ``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu
tests/``.
"""
import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax

# the card-only tests (marker gpu) run with JAX_PLATFORMS=cuda,cpu
jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")

import jax.numpy as jnp
import numpy as np
import pytest

# ---------------------------------------------------------------------------
# Quick lane: `pytest -m quick` runs a ~2-minute smoke subset — one or two
# fast, representative tests per subsystem — so suite health is checkable
# without the 20-35 minute full run. Maintained here (not as decorators) so
# the whole lane is visible and editable in one place.
# ---------------------------------------------------------------------------
QUICK_TESTS = {
    # profiles: float64 oracle + AD-consistency
    "test_profiles.py::test_epl",
    "test_profiles.py::test_hessian_symmetry_epl",
    "test_epl_gradients.py::test_epl_custom_vjp_matches_fd",
    "test_profiles_extended.py::test_nfw_oracle",
    "test_profiles_extra.py::test_nie_reduces_to_sie",
    # simulator + conv paths
    "test_simulator.py::test_dft_matches_fft_conv",
    "test_simulator.py::test_simulate_shapes_and_finiteness",
    "test_render_families.py::test_lstsq_component_stack_matches_float64",
    # prob stack
    "test_prob.py::test_prior_roundtrip",
    "test_prob.py::test_bijector_fldj_matches_autodiff",
    # inference drivers
    "test_inference.py::test_map_nonzero_lr_moves",
    "test_inference.py::test_hmc_shapes",
    "test_inference.py::test_smc_pixels_only_default_aux_and_segments",
    # sharding / multi-device
    "test_sharding.py::test_sharded_log_prob_matches",
    # cluster machinery
    "test_cluster.py::test_mass_series_dpie_matches_direct",
    # survey mode (incl. grouped HMC)
    "test_survey.py::test_grouped_hmc_per_group_adaptation",
    # inversion, point sources, multi-plane
    "test_inversion.py::test_marginal_likelihood_matches_float64_oracle",
    "test_pointsource.py::test_sis_time_delay_analytic",
    "test_multiplane.py::test_single_lens_multiplane_equals_single_plane",
    # models / positions / analysis / utils / aot
    "test_backward_model.py::test_backward_log_prob_and_map",
    "test_positions.py::test_positions_likelihood_peaks_at_truth",
    "test_lensing_analysis.py::test_sis_tangential_critical_curve_is_einstein_ring",
    "test_utils.py::test_ess_iid_is_full",
    "test_aot.py::test_aot_program_roundtrip",
    "test_round2_fixes.py::test_ellipticity_to_polar_gradient_finite_at_origin",
    "test_gpu_port.py::test_psf_auto_mode_is_fft_on_every_backend",
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        # item.nodeid is like "tests/test_x.py::test_y[param]"
        base = item.nodeid.split("/")[-1].split("[")[0]
        if base in QUICK_TESTS:
            item.add_marker(pytest.mark.quick)

from gigalens_tpu import PhysicalModel, SimulatorConfig
from gigalens_tpu.prob import Prior
from gigalens_tpu.prob import distributions as gld
from gigalens_tpu.profiles.light.sersic import SersicEllipse
from gigalens_tpu.profiles.mass.epl import EPL
from gigalens_tpu.profiles.mass.shear import Shear


@pytest.fixture(scope="session")
def demo_prior():
    """The canonical EPL+Shear / SersicEllipse prior of the reference demo
    (reference tests/conftest.py:20-73), expressed as a gigalens_tpu Prior."""
    return Prior(
        dict(
            lens_mass=[
                dict(
                    theta_E=gld.LogNormal(jnp.log(1.25), 0.25),
                    gamma=gld.TruncatedNormal(2, 0.25, 1, 3),
                    e1=gld.Normal(0, 0.1),
                    e2=gld.Normal(0, 0.1),
                    center_x=gld.Normal(0, 0.05),
                    center_y=gld.Normal(0, 0.05),
                ),
                dict(gamma1=gld.Normal(0, 0.05), gamma2=gld.Normal(0, 0.05)),
            ],
            lens_light=[
                dict(
                    R_sersic=gld.LogNormal(jnp.log(1.0), 0.15),
                    n_sersic=gld.Uniform(2, 6),
                    e1=gld.TruncatedNormal(0, 0.1, -0.3, 0.3),
                    e2=gld.TruncatedNormal(0, 0.1, -0.3, 0.3),
                    center_x=gld.Normal(0, 0.05),
                    center_y=gld.Normal(0, 0.05),
                    Ie=gld.LogNormal(jnp.log(500.0), 0.3),
                )
            ],
            source_light=[
                dict(
                    R_sersic=gld.LogNormal(jnp.log(0.25), 0.15),
                    n_sersic=gld.Uniform(0.5, 4),
                    e1=gld.TruncatedNormal(0, 0.15, -0.5, 0.5),
                    e2=gld.TruncatedNormal(0, 0.15, -0.5, 0.5),
                    center_x=gld.Normal(0, 0.25),
                    center_y=gld.Normal(0, 0.25),
                    Ie=gld.LogNormal(jnp.log(150.0), 0.5),
                )
            ],
        )
    )


@pytest.fixture(scope="session")
def demo_physmodel():
    return PhysicalModel([EPL(30), Shear()], [SersicEllipse()], [SersicEllipse()])


@pytest.fixture(scope="session")
def small_sim_config():
    return SimulatorConfig(delta_pix=0.1, num_pix=20)


@pytest.fixture(scope="session")
def demo_data():
    return np.zeros((20, 20), np.float32), 0.1, 100.0  # image, bkg_rms, exp_time


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu_device():
    """The first GPU; skips the test where there is none. Decided here, at
    run time, so every xdist worker collects the same tests."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs a GPU (on the card: JAX_PLATFORMS=cuda,cpu "
                    "python -m pytest -m gpu tests/)")
    return gpus[0]
