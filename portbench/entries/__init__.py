"""The program's entries that traffic mixes drive, one module each.

A module has ``setup(ctx)``, which returns an object with ``unit(i)`` (one
unit of work), ``finish()`` (the end of the window), ``end_to_end(lat,
window_s)``, the cell's counts for the per-layer readers, ``release()``
(frees the program's state) and ``check()`` (the numbers that decide
``correct``, each with its limit, from the plain reference).
"""
