"""Table generators of their own, one module a schema.

A table spec whose ``generator`` is not one of ``gen.GENERATORS`` names
the module ``generators/<name>.py`` here, whose ``generate(tspec, seed,
salt)`` returns its ``gen.RawTable``s; ``gen.make_tables`` gives it the
same seed and salt it gives the built-in generators.
"""
