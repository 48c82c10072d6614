"""Host utilities copied from the JAX package: combinatorics, quadrature
rules, batched evaluation of user callables and integration over meshes
(``integration``)."""

from . import integration
