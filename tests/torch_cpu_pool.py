"""One thread for torch's CPU pool in the port's tests.

Every ``tests/test_torch_*.py`` imports this module at its top, and so
states that it runs at this pin. By default torch runs its intra-op pool at
a thread per core. Beside other busy processes (the suite runs six xdist
workers on an eight-core host, and other jobs may share the machine) each
small op then waits at the pool's barrier for threads that are not
scheduled: one 256x144 red_buoy chain call took 15.5 s at eight threads
against 0.04 s at one (``python scripts/cpu_pool_under_load.py``). The
tests' tensors are small, so one thread is faster even on an idle machine:
the tier-1 command took 377.5 s with the pin against 772.9 s without it on
an idle eight-core Intel Xeon host, six workers at eight threads each
having oversubscribed its cores.

xdist imports every test module in every worker while it collects, so the
pin holds in each worker for the whole run, the JAX test files' too. It
changes nothing that XLA does: XLA's CPU backend keeps its own thread pool.
The inter-op pool is left alone (torch sizes it only before its first
inter-op work).

A child Python that a port test starts and that imports torch gets
``CHILD_ENV`` in its environment: torch reads ``OMP_NUM_THREADS`` when it
starts its pool. A child that imports this module under that environment
is pinned already and does not import torch for it (importing torch takes
seconds of CPU, and ``run_private``'s own test children need no torch).
"""

import os

THREADS = 1
CHILD_ENV = {"OMP_NUM_THREADS": str(THREADS)}

if os.environ.get("OMP_NUM_THREADS") != CHILD_ENV["OMP_NUM_THREADS"]:
    import torch

    torch.set_num_threads(THREADS)
