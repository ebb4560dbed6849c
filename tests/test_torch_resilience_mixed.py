"""Serving resilience of the PyTorch port on the mixed-step engine
(``ServingEngine(mixed_step=True)``: every step one ragged dispatch of
the queued prefill chunks and the decode rows) against the JAX
reference's mixed-step engine ``ServingEngine(attention="jax",
mixed_step=True)``: the drills of tests/serving_drills.py, as
tests/test_torch_resilience.py runs them on the per-phase engine.
Deadlines, prefill faults and copy-on-write run while the mixed
dispatch packs its prefill rows; ``decode_error`` and ``stall`` fire
before its replay. A prefill row whose chunk would read a page that an
earlier prefilling request has not written waits for it (ROADMAP C14),
and the teardown finishes its sweep when an abort raises (C15)."""
import pytest
import torch

import serving_drills as drills

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def ref():
    return drills.reference()


@pytest.mark.parametrize("name", list(drills.DETERMINISTIC))
def test_mixed_drill_matches_the_jax_mixed_engine(ref, name):
    drills.check_deterministic(ref, name, mixed=True)


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_mixed_preempt_resume_over_quantized_pools(ref, kv_dtype):
    drills.check_preempt_resume_quant(ref, True, kv_dtype)


def test_mixed_sampled_preempted_stream_equals_the_unpreempted_run(ref):
    drills.check_sampled_resume(ref, True)


@pytest.mark.parametrize("name", list(drills.TIMED))
def test_mixed_timed_drill_finish_reasons(ref, name):
    drills.check_timed(ref, name, mixed=True)


def test_mixed_overload_stress_verifies_after_every_step(ref):
    drills.check_stress(ref, True)


def test_mixed_failing_program_tears_down_and_reraises(ref):
    drills.check_synthetic_failure(ref, True)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_mixed_eject_and_admit_migrated(ref, temperature):
    drills.check_migration(ref, True, temperature)


@pytest.mark.parametrize("seed", range(6))
def test_mixed_shared_prefix_admitted_together(ref, seed):
    drills.check_shared_prefix_admitted_together(ref, seed)


@pytest.mark.parametrize("spec", [False, True])
def test_mixed_teardown_survives_a_failing_abort(ref, spec):
    drills.check_teardown_past_a_failing_abort(ref, True, spec)
