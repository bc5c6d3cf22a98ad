"""The benchmark's guard against JAX.

Nothing a benchmark run loads may be JAX or the JAX package of this
repository: the port (``csparse3_tpu_torch``) is measured, the JAX package
(``csparse3_tpu``) is not.  A module counts by its top-level name, the
part before the first dot, compared whole: the port's name begins with the
JAX package's, so a prefix test would be wrong.
"""

from __future__ import annotations

import sys

#: top-level module names that no benchmark run may hold
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "csparse3_tpu"})


def forbidden_modules(names=None) -> list[str]:
    """The top-level names among ``names`` (default: ``sys.modules``) that
    are in ``FORBIDDEN``, sorted."""
    names = sys.modules if names is None else names
    return sorted({n.split(".", 1)[0] for n in names}
                  & FORBIDDEN)
