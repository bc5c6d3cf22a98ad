"""The plain reference of the benchmark: NumPy and SciPy only.

It rebuilds from a grid's branch and bus arrays everything the program
derives (Ybus, B', B'', the reduced DC matrix, islands) and solves with
``scipy.sparse.linalg``.  It imports neither JAX, nor the JAX package, nor
anything of the program, and takes nothing the program made: it reads the
program's answers only to judge them (``compare``).
"""
