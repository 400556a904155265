"""The plain reference that decides a run's ``correct``, and the
comparisons. It imports neither JAX nor the port: ``slam`` is a frozen copy of
the port's plain path, run on the inputs the benchmark generated."""
