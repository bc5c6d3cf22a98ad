"""Build helpers, interop with the JAX package's state, persistence
(``io``), profiling and small host utilities (``misc``)."""
