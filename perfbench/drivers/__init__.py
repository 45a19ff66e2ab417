"""The drivers: one module per kind of traffic, named by a traffic file's
``driver`` key.  Each defines ``Driver(config, traffic, seed, device)``
with ``setup()`` (inputs from the seed, the program's objects, the
checked first steps, warm-up), ``unit()`` (one step or frame through the
program's entry, synchronised; False if it failed), ``release()`` (frees
the program's state), ``check()`` (the numbers compared with the
reference), ``end_to_end(units, window_s)`` and ``launch_bounds(kernel)``
(the least time of each launch the window made, for the rooflines)."""
