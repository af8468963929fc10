"""Carry-corrected value assembly vs an independent host implementation of
the reference logic (meterelf/_reading.py:163-182)."""
import numpy as np
import jax.numpy as jnp

from meterelf_jax.ops.angles import assemble_value


def reference_value(r4, r3, r2, r1):
    d3 = (int(r3)
          + (1 if r3 % 1.0 > 0.55 and r4 <= 2 else 0)
          - (1 if r3 % 1.0 < 0.45 and r4 >= 8 else 0)) % 10
    d2 = (int(r2)
          + (1 if r2 % 1.0 > 0.55 and d3 <= 2 else 0)
          - (1 if r2 % 1.0 < 0.45 and d3 >= 8 else 0)) % 10
    d1 = (int(r1)
          + (1 if r1 % 1.0 > 0.55 and d2 <= 2 else 0)
          - (1 if r1 % 1.0 < 0.45 and d2 >= 8 else 0)) % 10
    return (d1 * 100.0) + (d2 * 10.0) + (d3 * 1.0) + r4 / 10.0


def test_assemble_value_fuzz():
    rng = np.random.default_rng(0)
    for _ in range(2000):
        pos = rng.uniform(0, 10, 4)
        got = float(assemble_value(jnp.asarray(pos, jnp.float64)))
        exp = reference_value(*pos)
        # XLA may fuse the digit arithmetic with FMA: allow ~1 ulp; the
        # discrete digits must match exactly
        assert abs(got - exp) < 1e-9, pos
        assert int(got) == int(exp), pos


def test_assemble_value_carry_edges():
    cases = [
        (1.26, 4.6, 9.8, 9.1),     # golden 905.126 pattern
        (9.9, 0.1, 0.0, 0.0),      # borrow chain
        (0.0, 9.56, 9.6, 9.6),     # carry chain
        (2.0, 5.56, 2.44, 8.0),    # boundary 0.55/0.45 exact (not >/<)
        (8.0, 0.44, 8.0, 0.44),
    ]
    for pos in cases:
        got = float(assemble_value(jnp.asarray(pos, jnp.float64)))
        exp = reference_value(*pos)
        assert abs(got - exp) < 1e-9 and int(got) == int(exp), pos
