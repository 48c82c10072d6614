"""Host utilities copied from the JAX package: combinatorics, quadrature
rules and batched evaluation of user callables."""
