"""Mesh sharding: multi-device execution matches single-device numerics.

Runs on 8 virtual CPU devices (XLA_FLAGS=--xla_force_host_platform_device_count=8
set in conftest), the test-time stand-in for a multi-GPU mesh.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from gigalens_tpu.inference import ModellingSequence
from gigalens_tpu.model import ForwardProbModel
from gigalens_tpu.parallel import default_mesh, shard_samples
from gigalens_tpu.simulator import LensSimulator


@pytest.fixture(scope="module")
def mesh():
    assert jax.device_count() == 8, "conftest must provide 8 virtual devices"
    return default_mesh()


def test_sharded_log_prob_matches(demo_prior, demo_physmodel, small_sim_config, mesh):
    pm = ForwardProbModel(
        demo_prior, np.zeros((20, 20), np.float32), background_rms=0.1, exp_time=100
    )
    sim = LensSimulator(demo_physmodel, small_sim_config, bs=16)
    z = demo_prior.unconstrain(demo_prior.sample(jax.random.PRNGKey(0), 16))

    lp_single, chi_single = jax.jit(lambda z: pm.log_prob(sim, z))(z)
    z_sharded = shard_samples(z, mesh)
    lp_shard, chi_shard = jax.jit(lambda z: pm.log_prob(sim, z))(z_sharded)
    np.testing.assert_allclose(lp_single, lp_shard, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(chi_single, chi_shard, rtol=1e-5, atol=1e-5)


def test_sharded_map_runs_and_matches(demo_prior, demo_physmodel, small_sim_config, mesh):
    pm = ForwardProbModel(
        demo_prior, np.zeros((20, 20), np.float32), background_rms=0.1, exp_time=100
    )
    seq_m = ModellingSequence(demo_physmodel, pm, small_sim_config, mesh=mesh)
    start = demo_prior.unconstrain(demo_prior.sample(jax.random.PRNGKey(0), 16))
    z_m = seq_m.MAP(optax.adam(1e-3), start=start, n_samples=16, num_steps=5)

    single = default_mesh(jax.devices()[:1])
    seq_s = ModellingSequence(demo_physmodel, pm, small_sim_config, mesh=single)
    z_s = seq_s.MAP(optax.adam(1e-3), start=start, n_samples=16, num_steps=5)
    np.testing.assert_allclose(np.asarray(z_m), np.asarray(z_s), rtol=1e-4, atol=1e-5)


def test_sharded_svi_matches_single_device(
    demo_prior, demo_physmodel, small_sim_config, mesh
):
    """Same seeds, same steps: the only 8-dev difference is the gradient
    all-reduce order, so the fitted surrogate must agree to float tolerance."""
    pm = ForwardProbModel(
        demo_prior, np.zeros((20, 20), np.float32), background_rms=0.1, exp_time=100
    )
    start = demo_prior.unconstrain(demo_prior.sample(jax.random.PRNGKey(1), 1))
    seq_m = ModellingSequence(demo_physmodel, pm, small_sim_config, mesh=mesh)
    q_m, loss_m = seq_m.SVI(start, optax.adam(1e-3), n_vi=16, num_steps=4)
    single = default_mesh(jax.devices()[:1])
    seq_s = ModellingSequence(demo_physmodel, pm, small_sim_config, mesh=single)
    q_s, loss_s = seq_s.SVI(start, optax.adam(1e-3), n_vi=16, num_steps=4)
    assert np.isfinite(np.asarray(loss_m)).all()
    np.testing.assert_allclose(
        np.asarray(loss_m), np.asarray(loss_s), rtol=1e-4, atol=1e-2
    )
    np.testing.assert_allclose(
        np.asarray(q_m.mean()), np.asarray(q_s.mean()), rtol=1e-4, atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(q_m.scale_tril), np.asarray(q_s.scale_tril),
        rtol=1e-3, atol=1e-5,
    )


def test_sharded_hmc_matches_single_device(
    demo_prior, demo_physmodel, small_sim_config, mesh
):
    """Deterministic threefry keys: 8-dev and 1-dev chains see identical
    momenta/uniforms, so the sample streams must agree (cross-device
    reduction order only perturbs the shared step size at float epsilon)."""
    from gigalens_tpu.prob.distributions import MultivariateNormalTriL

    pm = ForwardProbModel(
        demo_prior, np.zeros((20, 20), np.float32), background_rms=0.1, exp_time=100
    )
    d = demo_prior.d
    start = demo_prior.unconstrain(demo_prior.sample(jax.random.PRNGKey(1), 1))
    q_z = MultivariateNormalTriL(start[0], jnp.eye(d) * 1e-3)
    seq_m = ModellingSequence(demo_physmodel, pm, small_sim_config, mesh=mesh)
    res_m = seq_m.HMC(q_z, n_hmc=16, num_burnin_steps=3, num_results=4, seed=0)
    single = default_mesh(jax.devices()[:1])
    seq_s = ModellingSequence(demo_physmodel, pm, small_sim_config, mesh=single)
    res_s = seq_s.HMC(q_z, n_hmc=16, num_burnin_steps=3, num_results=4, seed=0)
    assert res_m.samples.shape == (4, 16, d)
    assert np.isfinite(np.asarray(res_m.samples)).all()
    np.testing.assert_allclose(
        np.asarray(res_m.samples), np.asarray(res_s.samples), rtol=1e-4, atol=1e-4
    )


def test_round_to_multiple(mesh):
    from gigalens_tpu.parallel import round_to_multiple

    assert round_to_multiple(500, 8) == 496
    assert round_to_multiple(3, 8) == 8
    assert round_to_multiple(16, 8) == 16


def test_sharded_smc_runs(demo_prior, demo_physmodel, small_sim_config, mesh):
    from gigalens_tpu.inference import ModellingSequence
    from gigalens_tpu.model import ForwardProbModel

    pm = ForwardProbModel(
        demo_prior, np.zeros((20, 20), np.float32), background_rms=0.1,
        exp_time=100,
    )
    seq = ModellingSequence(demo_physmodel, pm, small_sim_config, mesh=mesh)
    res = seq.SMC(num_particles=16, num_ensembles=1, num_leapfrog_steps=2,
                  post_sampling_steps=2, max_stage=2, seed=0,
                  segment_stages=1)
    assert np.isfinite(np.asarray(res.particles)).all()

    # same run on a single device: identical keys, so the tempering
    # schedule and particle stream must agree to float tolerance (the
    # resampling gather is the only cross-device traffic)
    single = default_mesh(jax.devices()[:1])
    seq_s = ModellingSequence(demo_physmodel, pm, small_sim_config, mesh=single)
    res_s = seq_s.SMC(num_particles=16, num_ensembles=1, num_leapfrog_steps=2,
                      post_sampling_steps=2, max_stage=2, seed=0,
                      segment_stages=1)
    np.testing.assert_allclose(
        np.asarray(res.final_beta), np.asarray(res_s.final_beta),
        rtol=1e-5, atol=1e-6,
    )
    # the move preconditioner's particle-covariance reduction crosses
    # devices, so its summation order differs 8-dev vs 1-dev; the ulp
    # difference feeds every particle's dynamics through the Cholesky
    # factor and grows to ~1e-3 relative over the moves — statistically
    # identical kernels, hence the looser tolerance than MAP's
    np.testing.assert_allclose(
        np.asarray(res.particles), np.asarray(res_s.particles),
        rtol=5e-3, atol=5e-3,
    )
