"""Run package doctests (the reference runs pytest --doctest-modules over
its package; the angle convention doctest is the one real example)."""
import doctest

import meterelf_jax.params as params_mod


def test_params_doctests():
    results = doctest.testmod(params_mod)
    assert results.attempted >= 1
    assert results.failed == 0
