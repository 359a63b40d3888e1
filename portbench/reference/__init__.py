"""The plain reference: NumPy over the generator's own arrays.

It rebuilds every partition's min / max from the raw columns, evaluates
each query's constraints in three-valued logic, builds the join's key set
and the top-k order itself, and judges the program's answers against that
(``judge``).  ``answer`` computes the same answers in a chosen precision:
in float64 it must pass its own judge, and in bfloat16 (the control) it
must fail.  Nothing here imports the program or JAX, and nothing reads
what the program made but the answers it is judging.
"""
