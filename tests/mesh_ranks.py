"""Rank functions for ``parallel.mesh.launch`` in the port's tests, in a
module that is quick to import: a spawned rank imports the module of its
function before it runs it."""

import time


def stall(device, seconds: float) -> None:
    """A rank that sleeps ``seconds`` outside any collective."""
    time.sleep(seconds)
