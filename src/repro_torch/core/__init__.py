"""Core: the masked LU factorization and the solve over its factors."""
