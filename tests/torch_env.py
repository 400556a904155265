"""One torch intra-op thread for each test process of the port.

Every ``tests/test_torch_*.py`` imports this module first. Importing it
calls ``torch.set_num_threads(1)``, so each worker of a ``pytest -n N``
run computes on one thread. Under ``--dist load`` every worker collects
every test module, so the whole worker is held to one thread, the JAX tests
it runs too (they do not use torch).

Why one thread:

* Under six xdist workers on an eight-core machine, each torch process
  started eight OpenMP threads: about 48 threads that spin-wait and fight
  each other for the cores. Tier-1 took 1,313 s of its 1,470 s cut, and the
  port's files took 6,376 of its 7,324 worker-seconds. Alone with eight
  threads, ``test_torch_step_graph``'s two sequence tests take 5.1 s and
  4.5 s, using 80.6 s of CPU for 20.3 s of wall time; under the six
  workers they took 256 s and 239 s. Alone on one thread they take 6.3 s
  and 5.5 s with 22.2 s of CPU. One thread loses about a fifth alone and
  saves four times the CPU, and under the workers it wins outright: the
  port's 36 files ran in 308 s of wall time at one thread.
* The float order of a reduction does not depend on the machine's cores
  or on the other test workers, so a test whose outcome turns on the last
  bits of a sum (which scan of a spilling session pays a creation drop)
  gives the same answer on every machine.

The port's child processes get the same: the multi-process tests start
their ranks with ``threads=1`` (``parallel.distributed.launch``), and the
subprocesses the tests start get ``OMP_NUM_THREADS=1`` in the environment
they are given. This test process's own ``os.environ`` is left as it is,
since the JAX tests' subprocesses inherit it.
"""
import torch

torch.set_num_threads(1)
