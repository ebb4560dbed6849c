"""Token selection of the PyTorch port
(paddle_tpu_torch/inference/sampler.py) against the JAX reference
(paddle_tpu/inference/sampler.py).

The two frameworks draw different random numbers from the same seed,
so the sampled path is compared with the SAME Gumbel noise fed to both:
the port's ``sample_token(lg, t, g)`` must equal
``argmax(lg / t + g)`` computed in jnp, which is the draw
``jax.random.categorical`` makes from its own noise."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference import sampler as jax_sampler
from paddle_tpu_torch.inference import sampler

# tiny shapes: a few threads are plenty, and the suite runs several
# workers at once beside timing-sensitive tests
torch.set_num_threads(2)


def _logits(seed, rows=6, vocab=97):
    lg = np.random.RandomState(seed).randn(rows, vocab).astype(np.float32)
    lg[0, 5] = lg[0, 40] = lg[0].max() + 1.0     # a tie: first index wins
    return lg


def test_greedy_matches_jax():
    lg = _logits(0)
    np.testing.assert_array_equal(
        sampler.greedy(torch.from_numpy(lg)).numpy(),
        np.asarray(jax_sampler.greedy(jnp.asarray(lg))))


@pytest.mark.parametrize("temp", [0.0, 1e-8, 0.7, 1.3])
def test_scale_by_temp_matches_jax(temp):
    lg = _logits(1)
    np.testing.assert_allclose(
        sampler.scale_by_temp(torch.from_numpy(lg), temp).numpy(),
        np.asarray(jax_sampler.scale_by_temp(jnp.asarray(lg),
                                             jnp.float32(temp))),
        rtol=1e-6)


def test_scale_by_temp_per_row_tensor():
    lg = _logits(2)
    temps = np.array([0.0, 0.5, 1.0, 2.0, 1e-9, 0.9], np.float32)
    np.testing.assert_allclose(
        sampler.scale_by_temp(torch.from_numpy(lg),
                              torch.from_numpy(temps)).numpy(),
        np.asarray(jax_sampler.scale_by_temp(jnp.asarray(lg),
                                             jnp.asarray(temps)[:, None])),
        rtol=1e-6)


@pytest.mark.parametrize("k", [0, 1, 5, 20])
def test_apply_top_k_exact_matches_jax(k):
    lg = _logits(3)
    np.testing.assert_array_equal(
        sampler.apply_top_k(torch.from_numpy(lg), k).numpy(),
        np.asarray(jax_sampler.apply_top_k(jnp.asarray(lg), k,
                                           approx=False)))


def test_approx_top_k_is_refused():
    with pytest.raises(NotImplementedError):
        sampler.apply_top_k(torch.zeros(3, 8), 2, approx=True)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_token_with_injected_noise_matches_jnp(seed):
    lg = _logits(10 + seed)
    rng = np.random.RandomState(seed)
    g = -np.log(-np.log(rng.uniform(1e-7, 1.0, lg.shape))).astype(
        np.float32)
    temps = np.array([0.8, 0.0, 1.5, 0.3, 0.0, 2.0], np.float32)
    got = sampler.sample_token(torch.from_numpy(lg),
                               torch.from_numpy(temps),
                               torch.from_numpy(g)).numpy()
    t = jnp.asarray(temps)[:, None]
    drawn = jnp.argmax(jnp.asarray(lg) / jnp.maximum(t, 1e-6)
                       + jnp.asarray(g), axis=-1)
    want = jnp.where(t[:, 0] > 0, drawn, jnp.argmax(jnp.asarray(lg), -1))
    np.testing.assert_array_equal(got, np.asarray(want))


def test_sample_token_without_noise_is_greedy():
    lg = torch.from_numpy(_logits(4))
    np.testing.assert_array_equal(
        sampler.sample_token(lg, torch.zeros(6)).numpy(),
        sampler.greedy(lg).numpy())


def test_gumbel_noise_is_seeded_and_standard():
    g1 = torch.Generator().manual_seed(5)
    g2 = torch.Generator().manual_seed(5)
    a = sampler.gumbel_noise((4, 9), g1, "cpu")
    b = sampler.gumbel_noise((4, 9), g2, "cpu")
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    big = sampler.gumbel_noise((200_000,), torch.Generator().manual_seed(6),
                               "cpu")
    assert torch.isfinite(big).all()
    assert abs(float(big.mean()) - 0.5772157) < 0.01   # Euler-Mascheroni
    assert abs(float(big.var()) - np.pi ** 2 / 6) < 0.03


def test_gumbel_max_draws_follow_the_softmax():
    """The Gumbel-max draw is the categorical of softmax(lg / t)."""
    lg = torch.tensor([[1.0, 0.2, -0.5, 0.7]]).repeat(40_000, 1)
    t = 0.7
    gen = torch.Generator().manual_seed(7)
    toks = sampler.sample_token(lg, torch.full((40_000,), t),
                                sampler.gumbel_noise(lg.shape, gen, "cpu"))
    freq = torch.bincount(toks, minlength=4).double() / 40_000
    want = torch.softmax(lg[0].double() / t, -1)
    assert float((freq - want).abs().max()) < 0.01
